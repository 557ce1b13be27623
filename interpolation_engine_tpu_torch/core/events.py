"""Structured execution-event logger.

The capability ported from the reference's native logger (reference:
rust-project/src/runtime.rs:45-375): every runtime event — task starts, chat
lifecycle, menu actions, gotos, math traces, deletes, for-iterations — is a
typed record with an RFC-3339 timestamp, rendered as a pretty line into the
``--log`` sink, and (new here) optionally as JSON-lines for machine
consumption. Value previews are shortened like the reference's
``preview_value``.

The batched VM adds device-side counters (instances, executed instructions,
park/ring statistics) reported through the same stream — the de-facto
execution trace SURVEY.md §5 describes, extended with timing.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any, Optional, TextIO

from .context import CTX
from .interp import str_preview


def _now_rfc3339() -> str:
    return datetime.now(timezone.utc).astimezone().isoformat(timespec="seconds")


# Event kinds (superset of the reference logger's ~20 kinds)
TASK_START = "task_start"
TASK_ERROR = "task_error"
GOTO = "goto"
GOTO_MAP = "goto_map"
MATH = "math"
MATH_TRACE = "math_trace"
FOR_ITERATION = "for_iteration"
DELETE = "delete"
SET = "set"
USER_INPUT = "user_input"
USER_CHOICE = "user_choice"
RANDOM_CHOICE = "random_choice"
CHAT_START = "chat_start"
CHAT_DELTA = "chat_delta"
CHAT_DONE = "chat_done"
CHAT_RETRY = "chat_retry"
CHAT_TRANSCRIPT = "chat_transcript"
MENU_OPEN = "menu_open"
MENU_ACTION = "menu_action"
SAVE = "save"
LOAD = "load"
RELOAD = "reload"
TERMINATED = "terminated"
PROGRAM_END = "program_end"
REPLACE_MAP = "replace_map"
AWAIT_INSERT = "await_insert"
WRITE = "write"
SPEAK = "speak"
VM_ROUND = "vm_round"          # device: one step-loop round
VM_PARK = "vm_park"            # device: instance parked to the host ring
VM_RESUME = "vm_resume"
VM_STATS = "vm_stats"


@dataclass
class Event:
    kind: str
    label: str = ""
    line: Optional[int] = None
    data: dict = field(default_factory=dict)
    timestamp: str = field(default_factory=_now_rfc3339)


def preview_value(value: Any) -> str:
    """Shortened, single-line preview of an arbitrary value."""
    return str_preview(value)


def format_pretty(event: Event) -> str:
    """One human-readable line per event, timestamped."""
    head = f"[{event.timestamp}] {event.kind:<14}"
    loc = f" {event.label}" if event.label else ""
    if event.line is not None:
        loc += f" (line {event.line})"
    parts = []
    for key, value in event.data.items():
        parts.append(f"{key}={preview_value(value)}"
                     if not isinstance(value, (int, float, bool))
                     else f"{key}={value}")
    body = ("  " + " ".join(parts)) if parts else ""
    return head + loc + body


def now_us() -> float:
    """Microseconds on the clock ``torch.profiler`` stamps its events with
    (``time.time_ns``), so a span lines up with a device trace."""
    return time.time_ns() / 1e3


# the span handed out while nothing records: reads no clock
_NO_SPAN = nullcontext()


class _Span:
    __slots__ = ("spans", "name", "start")

    def __init__(self, spans: list, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.start = now_us()
        return self

    def __exit__(self, *exc):
        self.spans.append((self.name, threading.get_ident(), self.start,
                           now_us()))
        return False


@dataclass
class Recording:
    """What ``recording()`` collected: ``spans`` as ``(name, thread id,
    start_us, end_us)`` in the order they ended, and ``counters``, each
    added under ``lock`` (the engines count from a thread per device)."""
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    lock: Any = field(default_factory=threading.Lock, repr=False,
                      compare=False)


class Recorder:
    """Spans and counters taken inside the engines' steps, on ``now_us``'s
    clock. Outside ``recording()`` a site costs one attribute test:
    ``span`` hands back one shared no-op, ``count`` returns at once (no
    lock, no clock, no dict)."""

    recorded: Optional[Recording] = None

    def span(self, name: str):
        """A context manager that records ``name`` around its block."""
        rec = self.recorded
        if rec is None:
            return _NO_SPAN
        return _Span(rec.spans, name)

    def count(self, name: str, k: int = 1) -> None:
        rec = self.recorded
        if rec is None:
            return
        with rec.lock:
            rec.counters[name] = rec.counters.get(name, 0) + k

    @contextmanager
    def recording(self):
        """Record spans and counters inside the block; yields the
        ``Recording`` they go into."""
        if self.recorded is not None:
            raise RuntimeError("already recording")
        rec = self.recorded = Recording()
        try:
            yield rec
        finally:
            self.recorded = None


class EventLogger(Recorder):
    """Renders events to the log sink; optionally mirrors JSON lines."""

    def __init__(self, sink: Optional[TextIO] = None,
                 json_sink: Optional[TextIO] = None):
        self._sink = sink
        self.json_sink = json_sink
        self.counters: dict[str, int] = {}

    @property
    def sink(self) -> TextIO:
        return self._sink if self._sink is not None else CTX.log_sink

    @property
    def enabled(self) -> bool:
        """True when some sink actually receives the rendered lines. With
        no --log the sink is os.devnull: rendering (timestamp, previews,
        f-strings) per event is pure waste — at ring scale (10⁵ parks × 2
        events each) it was ~25% of the host servicing time."""
        if self.json_sink is not None:
            return True
        import os
        return getattr(self.sink, "name", None) != os.devnull

    def emit(self, kind: str, label: str = "", line: Optional[int] = None,
             **data):
        self.counters[kind] = self.counters.get(kind, 0) + 1
        if not self.enabled:
            return None
        event = Event(kind=kind, label=label, line=line, data=data)
        print(format_pretty(event), file=self.sink, flush=True)
        if self.json_sink is not None:
            record = {"ts": event.timestamp, "kind": kind, "label": label,
                      "line": line, **{
                          k: (v if isinstance(v, (int, float, bool, str,
                                                  type(None))) else repr(v))
                          for k, v in data.items()}}
            print(json.dumps(record), file=self.json_sink, flush=True)
        return event

    def task_start(self, task: dict):
        if not self.enabled:
            self.counters[TASK_START] = \
                self.counters.get(TASK_START, 0) + 1
            return
        self.emit(TASK_START, label=task.get("traceback_label", "?"),
                  line=task.get("line"),
                  **{k: v for k, v in task.items()
                     if k not in ("traceback_label", "line", "cmd")})

    def transcript(self, messages: list):
        if not self.enabled:  # skip per-message previews without a sink
            self.counters[CHAT_TRANSCRIPT] = \
                self.counters.get(CHAT_TRANSCRIPT, 0) + 1
            return
        self.emit(CHAT_TRANSCRIPT, n_messages=len(messages))
        for m in messages:
            print(f"    {m['role'].upper()}: {preview_value(m['content'])}",
                  file=self.sink)


# Default process-wide logger (sink resolves lazily through CTX).
EVENTS = EventLogger()
