"""The benchmark's arithmetic: end-to-end statistics, the reading of a
profiler trace, and the per-layer metric kinds that ``metrics/*.json``
files name.

Everything here is plain Python over numbers and tuples, so the tests run
it on made-up series and traces. Times in a trace are microseconds.
"""

from __future__ import annotations

import importlib
import json
import math
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
SPAN_PREFIX = "portbench."


# ---- end to end ------------------------------------------------------------

def rate(work: int, seconds: float) -> float:
    """All of the window's work over all of its time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at
    least 95 % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


# ---- a profiler trace ------------------------------------------------------

class Op(NamedTuple):
    name: str
    start: float
    end: float


class Trace(NamedTuple):
    """What the traced segment left: its start and end, the device's
    operations, the harness's spans and the host's other operations (on
    a card, the CUDA runtime's calls)."""
    window: tuple          # (start, end) of the traced segment
    device: list           # [Op] kernels, copies and sets on the card
    spans: list            # [Op] the harness's own spans (SPAN_PREFIX)
    host: list             # [Op] the host's other operations
    rounds: int            # rounds run in the segment
    round_steps: int       # VM steps a round

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        """Device operations that are kernels, not copies or sets."""
        return [op for op in self.device
                if not op.name.startswith(("Memcpy", "Memset"))]


def read_profile(events, window: tuple, rounds: int,
                 round_steps: int) -> Trace:
    """A ``Trace`` from ``(name, on_device, start_us, end_us)`` events and
    the segment's ``(start_us, end_us)`` on the same clock. Events named
    with ``SPAN_PREFIX`` are the harness's own spans; device operations
    are clipped to the segment."""
    device, spans, host = [], [], []
    for name, on_device, start, end in events:
        op = Op(name, float(start), float(end))
        if name.startswith(SPAN_PREFIX):
            spans.append(op)
        elif on_device:
            device.append(op)
        else:
            host.append(op)
    lo, hi = window
    device = [Op(o.name, max(o.start, lo), min(o.end, hi)) for o in device
              if o.end > lo and o.start < hi]
    return Trace(window, device, spans, host, rounds, round_steps)


def union(intervals) -> list:
    """Merged, sorted (start, end) pairs covering the same time."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_us(trace: Trace) -> float:
    return sum(e - s for s, e in union((o.start, o.end)
                                       for o in trace.device))


def gaps(trace: Trace) -> list:
    """The device's idle (start, end) intervals within the segment."""
    out, t = [], trace.window[0]
    for s, e in union((o.start, o.end) for o in trace.device):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        out.append((t, trace.window[1]))
    return out


def _innermost(ops, t: float):
    inside = [o for o in ops if o.start <= t <= o.end]
    return min(inside, key=lambda o: o.end - o.start) if inside else None


def breakdown(trace: Trace, top: int = 10, width: int = 100) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by what the host was doing at their middle: the harness's
    span, then the innermost host operation."""
    by_name: dict = {}
    for op in trace.device:
        by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for s, e in sorted(gaps(trace), key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) / 2
        span = _innermost(trace.spans, mid)
        inner = _innermost(trace.host, mid)
        name = (span.name[len(SPAN_PREFIX):] if span else "between spans")
        if inner:
            name += " / " + inner.name
        idle.append([name[:width], (e - s) / 1e6])
    return {"device_ops": [[n[:width], us / 1e6] for n, us in device_ops],
            "idle_gaps": idle}


# ---- per-layer metric kinds ------------------------------------------------

def _named(trace: Trace, names) -> list:
    return [op for op in trace.kernels()
            if any(n in op.name for n in names)]


def idle_share(spec, trace, ctx):
    """The segment less the union of device operations, over the
    segment, in %."""
    if trace is None or trace.window_us <= 0 or not trace.device:
        return None
    return 100.0 * (trace.window_us - busy_us(trace)) / trace.window_us


def kernels_per_step(spec, trace, ctx):
    """Kernels launched in the segment over the VM steps it ran."""
    if trace is None or not trace.kernels():
        return None
    return len(trace.kernels()) / (trace.rounds * trace.round_steps)


def kernel_share(spec, trace, ctx):
    """The named kernels' device time over the device's busy time, in %."""
    if trace is None:
        return None
    named = _named(trace, spec["kernels"])
    if not named:
        return None
    return 100.0 * sum(o.end - o.start for o in named) / busy_us(trace)


def kernel_roofline(spec, trace, ctx):
    """The named bound's least time a launch over the named kernels' mean
    time a launch, in %."""
    if trace is None:
        return None
    named = _named(trace, spec["kernels"])
    if not named:
        return None
    mean_ms = sum(o.end - o.start for o in named) / len(named) / 1e3
    bound = importlib.import_module(f"portbench.bounds.{spec['bound']}")
    return 100.0 * bound.bound_ms(ctx, peaks()) / mean_ms


def span(spec, trace, ctx):
    """A host-clock span the harness timed around a call into a layer,
    in seconds."""
    return ctx.get("spans", {}).get(spec["span"])


def window_p95(spec, trace, ctx):
    """The 95th percentile of the window's rounds, in ms."""
    return p95(ctx["rounds_ms"]) if ctx.get("rounds_ms") else None


KINDS = {"idle_share": idle_share, "kernels_per_step": kernels_per_step,
         "kernel_share": kernel_share, "kernel_roofline": kernel_roofline,
         "span": span, "window_p95": window_p95}


def peaks(path: Path = HERE / "bounds" / "peaks.json") -> dict:
    return json.loads(path.read_text())


def per_layer(specs, trace, ctx) -> dict:
    """Each metric whose reader finds something to read, with its unit;
    the others are left out."""
    out = {}
    for spec in specs:
        value = KINDS[spec["kind"]](spec, trace, ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out
