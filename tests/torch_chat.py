"""Chat for the port's tests and ``chip_smoke.py``: the fake chat server of
``tests/fake_sse_server.py`` on a thread of its own (the device engines run
their own event loop), the replies it gives, and the chat programs of
``torch_programs`` pointed at it; the filter's test streams. No JAX."""

import asyncio
import contextlib
import random
import threading

import numpy as np
import torch

import torch_programs as tp
from fake_sse_server import FakeSSEServer

CHAT_PROGRAMS = {"turns": tp.CHAT_TURNS, "parallel": tp.CHAT_PARALLEL}
# turbo widths that hold the replies' lists (3 elements up to 60 bytes) and
# the output of every turn: no promotion, no escape
CHAT_SIZES = dict(width=128, out_width=512, elem_width=64)


def chat_program(name: str, url: str) -> str:
    return CHAT_PROGRAMS[name] % {"url": url}


def reply(body) -> str:
    """A reply to the last user message: prose, two ``<out>`` spans (the
    first with a ``<think>`` block inside, which the visual text hides),
    non-ASCII text, and for even turns a third span cut inside its stop
    delimiter, which the filters hold back."""
    user = body["messages"][-1]["content"]
    text = (f"Let me see. <out>first é {user} <think>plan {user}</think>"
            f"shown</out> between <out>second ✓ {user}</out> tail")
    if user[-1] in "02468":
        text += f" <out>third {user}</o"
    return text


@contextlib.contextmanager
def sse_server(responder=reply, chunk_size: int = 1):
    """A chat server answering on localhost from its own thread and event
    loop until the block ends."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server = FakeSSEServer(responder, chunk_size)
    try:
        asyncio.run_coroutine_threadsafe(server.__aenter__(), loop).result(30)
        yield server
    finally:
        if server._server is not None:
            asyncio.run_coroutine_threadsafe(
                server.__aexit__(None, None, None), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()


# ---- the filter's test streams ------------------------------------------------

# tests/test_filter_kernel.py's curated cases (raw, start, stop, hide_start,
# hide_stop, enumerate), here without the JAX package for the card's tests;
# tests/test_torch_filter_kernel.py holds the two lists equal
FILTER_CASES = [
    ("<output>hello</output>", "<output>", "</output>", "", "", False),
    ("junk <output>a</output> mid <output>b</output> tail",
     "<output>", "</output>", "", "", False),
    ("<output>a</output><output>b</output><output>c</output>",
     "<output>", "</output>", "", "", True),
    ("no delimiters at all", "<o>", "</o>", "", "", False),
    ("<o>unterminated span", "<o>", "</o>", "", "", False),
    ("prefix <o>x</o>", "<o>", "</o>", "", "", False),
    ("", "<o>", "</o>", "", "", False),
    ("", "", "", "", "", False),
    ("anything goes", "", "", "", "", False),
    ("pass with <think>hidden</think> text", "", "", "<think>", "</think>",
     False),
    ("<o>keep <think>drop</think> keep</o>", "<o>", "</o>",
     "<think>", "</think>", False),
    ("<o>a</o>\n<o><think>x</think>b</o>", "<o>", "</o>",
     "<think>", "</think>", True),
    ("[[x]] [[y]]", "[[", "]]", "", "", True),
    ("||a||b||c||", "||", "||", "", "", False),
    ("<o></o>", "<o>", "</o>", "", "", False),
    ("<think>lead</think><o>z</o>", "<o>", "</o>", "<think>", "</think>",
     False),
]


# texts cut at every length with the bytes past the length left in the row:
# delimiters that run past the length, hold-backs next to consumed bytes
CUT_TEXTS = [
    ("<o>a</</o><o>b<h>c</h><o>d</o>x<o", ("<o>", "</o>", "<h>", "</h>")),
    ("a<<h>x</h>y<h>z</h><", ("", "", "<h>", "</h>")),
    ("||a||b||||c|", ("||", "||", "|", "||")),
]


def cut_rows(text: str):
    """Rows of ``text`` whole, one per length 0 .. len(text)."""
    data = text.encode()
    bufs = np.tile(np.frombuffer(data, np.uint8), (len(data) + 1, 1))
    return (torch.from_numpy(bufs.copy()),
            torch.arange(len(data) + 1, dtype=torch.int32))


def rows(streams, L: int = None):
    """(bufs, lengths) as torch CPU tensors for a list of str or bytes,
    padded to L (default the JAX call site's width for the longest)."""
    data = [s.encode() if isinstance(s, str) else s for s in streams]
    if L is None:
        L = max(64, 1 << max([len(d) for d in data] + [1]).bit_length())
    bufs = np.zeros((len(data), L), np.uint8)
    for r, d in enumerate(data):
        bufs[r, :len(d)] = np.frombuffer(d, np.uint8)
    return (torch.from_numpy(bufs),
            torch.tensor([len(d) for d in data], dtype=torch.int32))


def fuzz_streams(seed: int = 991, count: int = 150) -> list:
    """tests/test_filter_kernel.py's fuzz: (raw, start, stop, hs, he,
    enum) with whole delimiters injected."""
    rng = random.Random(seed)
    delim_sets = [("<o>", "</o>", "", ""), ("<o>", "</o>", "<h>", "</h>"),
                  ("AB", "CD", "", ""), ("**", "**", "", ""),
                  ("", "", "<h>", "</h>")]
    out = []
    for _ in range(count):
        start, stop, hs, he = rng.choice(delim_sets)
        raw = "".join(rng.choices("ab<o></h>AB CD*\n", k=rng.randint(0, 60)))
        for _ in range(rng.randint(0, 4)):
            pos = rng.randint(0, len(raw))
            raw = raw[:pos] + rng.choice(
                [d for d in (start, stop, hs, he) if d] or [""]) + raw[pos:]
        out.append((raw, start, stop, hs, he, rng.random() < 0.4))
    return out


def by_delimiters(streams) -> dict:
    """{(start, stop, hs, he, enum): [raw, ...]}: one batch a set."""
    groups = {}
    for raw, *key in streams:
        groups.setdefault(tuple(key), []).append(raw)
    return groups


# the chat-shaped streams' delimiters (benchmarks/filter_probe.py's shape)
STREAM_DELIMS = ("<out>", "</out>", "<think>", "</think>")


def chat_stream(i: int, length: int, rng: random.Random,
                spans: int = None) -> bytes:
    """A chat reply of about ``length`` bytes, after
    benchmarks/filter_probe.py's ``make_stream``: prose, then 1-4 ``<out>``
    spans (``spans`` when given) with prose between them, a ``<think>``
    block inside the first span, non-ASCII text; the parts sized so that
    every span fits, the stream padded with prose and cut at ``length``
    (inside a delimiter too), then back to whole UTF-8 characters."""
    n = rng.randint(1, 4) if spans is None else spans

    def grow(unit: str, size: int) -> str:
        return (unit * (size // len(unit) + 1))[:size]
    fill = max((length - 11 * n - 40) // (2 * n + 1), 4)
    prose = f"thinking about item {i}, é and ✓ ... "
    parts = [grow(prose, fill)]
    for k in range(n):
        think = f"<think>plan {i}</think>" if k == 0 else ""
        parts += ["<out>", think, grow(f"answer {i}.{k} alpha ", fill),
                  "</out>", grow(f" filler {k} ", fill)]
    data = ("".join(parts) + grow(prose, length)).encode()[:length]
    return data.decode("utf-8", "ignore").encode()
