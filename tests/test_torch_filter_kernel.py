"""The port's chat filter (``ops/filter_kernel.py``) against the JAX
package's and the host filters, on the CPU, where the wrapper runs its plain
version; and the chat service and chat programs through the port's engines.

The same streams go through the JAX ``filter_chat_text`` (jitted on the CPU,
one stream a call, ``out_size = 2 L + 256``) and the port's batched one:
every field equal byte for byte (the port's ``visual`` is ``L + 256`` wide;
JAX's is 0 past it). ``filter_chat_host`` of both packages must equal the
host filters fed one character at a time; where the JAX kernel and the host
disagree (a hide start with no hide stop), the port follows the JAX kernel.
The service and the engines run with ``filter_chat_host`` defaulting to the
CPU, against ``tests/fake_sse_server.py`` on a thread (``torch_chat``), and
must equal the JAX package's host runtime fed the same server one character
a chunk. Exact equality everywhere: these are bytes."""

import asyncio
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_chat as tc
from torch_chat import by_delimiters, fuzz_streams, rows
from test_filter_kernel import CASES, host_filter
from torch_helpers import compile_port

from interpolation_engine_tpu.core.runtime import async_main
from interpolation_engine_tpu.io.manager import BufferBackend, IOManager
from interpolation_engine_tpu.ops import filter_kernel as jfk
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import filter_kernel as fk


def jax_text(raw: bytes, L: int, start, stop, hs, he, enum) -> dict:
    buf = np.zeros((L,), np.uint8)
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    out = jfk.filter_chat_text(
        jnp.asarray(buf), jnp.int32(len(raw)), start=start.encode(),
        stop=stop.encode(), hide_start=hs.encode(), hide_stop=he.encode(),
        enumerate_outputs=enum, out_size=2 * L + 256)
    return {k: np.asarray(v) for k, v in out.items()}


def port_text(raws, start, stop, hs, he, enum, L=None) -> dict:
    bufs, lengths = rows(raws, L)
    return fk.filter_chat_text(bufs, lengths, start=start, stop=stop,
                               hide_start=hs, hide_stop=he,
                               enumerate_outputs=enum)


def assert_batch_equals_jax(raws, start, stop, hs, he, enum, L=None):
    """The port's batch, row by row, equal to the JAX function on each
    stream alone."""
    data = [r.encode() if isinstance(r, str) else r for r in raws]
    got = port_text(data, start, stop, hs, he, enum, L)
    L = got["extracted"].shape[1]
    W = fk.visual_width(L)
    assert got["visual"].shape == (len(data), W)
    for r, raw in enumerate(data):
        want = jax_text(raw, L, start, stop, hs, he, enum)
        assert not want["visual"][W:].any()
        want["visual"] = want["visual"][:W]
        for key, value in want.items():
            assert np.array_equal(got[key][r].numpy(), value), (raw, key)
    return got


def assert_host_calls_agree(raw, start, stop, hs, he, enum):
    want = host_filter(raw, start, stop, hs, he, enum, chunk=1)
    assert jfk.filter_chat_host(raw, start, stop, hs, he, enum) == want
    assert fk.filter_chat_host(raw, start, stop, hs, he, enum,
                               device="cpu") == want


def test_the_cases_are_the_jax_tests():
    """torch_chat's JAX-free copy of tests/test_filter_kernel.py's curated
    cases (the card's tests use it) is the JAX package's list."""
    assert tc.FILTER_CASES == CASES


@pytest.mark.parametrize("case", range(len(CASES)))
def test_curated_case_equals_jax_and_the_host(case):
    raw, start, stop, hs, he, enum = CASES[case]
    assert_batch_equals_jax([raw], start, stop, hs, he, enum)
    assert_host_calls_agree(*CASES[case])


def test_span_overflow_returns_the_exact_oracle():
    """More than MAX_SPANS outputs: filter_chat_host returns the host
    oracle (all 20 spans) and counts it; the batched call reports the raw
    count and clips the table as JAX does."""
    raw = "".join(f"<o>s{k}</o>," for k in range(20))
    with EVENTS.recording() as rec:
        outputs, visual = fk.filter_chat_host(raw, "<o>", "</o>", "", "",
                                              True, device="cpu")
    assert rec.counters.get("host.chat_filter", 0) == 1
    assert len(outputs) == 20
    assert (outputs, visual) == host_filter(raw, "<o>", "</o>", "", "",
                                            True, chunk=1)
    got = assert_batch_equals_jax([raw], "<o>", "</o>", "", "", True)
    assert (int(got["raw_n_spans"][0]), int(got["n_spans"][0])) == (20, 16)


@pytest.mark.parametrize("seed", [991, 5])
def test_fuzz_equals_jax_and_the_host(seed):
    """tests/test_filter_kernel.py's 150-stream fuzz (seed 991, and one
    more seed): a mixed-length batch a delimiter set against JAX on each
    stream, and each stream's host call against both packages' and the
    host filters'."""
    streams = fuzz_streams(seed)
    for (start, stop, hs, he, enum), raws in by_delimiters(streams).items():
        assert_batch_equals_jax(raws, start, stop, hs, he, enum, 128)
    for stream in streams:
        assert_host_calls_agree(*stream)


@pytest.mark.parametrize("text", range(len(tc.CUT_TEXTS)))
def test_cut_at_every_length_equals_jax(text):
    """A text cut at every length with the rest of it left in the row: JAX's
    masks (a match lies within the length) and hold-back (no consumed
    byte) on every row."""
    raw, (start, stop, hs, he) = tc.CUT_TEXTS[text]
    bufs, lengths = tc.cut_rows(raw)
    L = bufs.shape[1]
    for enum in (False, True):
        got = fk.filter_chat_text(bufs, lengths, start=start, stop=stop,
                                  hide_start=hs, hide_stop=he,
                                  enumerate_outputs=enum)
        for r in range(L + 1):
            out = jfk.filter_chat_text(
                jnp.asarray(bufs[r].numpy()), jnp.int32(r),
                start=start.encode(), stop=stop.encode(),
                hide_start=hs.encode(), hide_stop=he.encode(),
                enumerate_outputs=enum, out_size=fk.visual_width(L))
            for key, value in out.items():
                assert np.array_equal(got[key][r].numpy(),
                                      np.asarray(value)), (r, key)


@pytest.mark.parametrize("enum", [False, True])
def test_mixed_length_batch_equals_jax_per_stream(enum):
    """Chat-shaped streams (``torch_chat.chat_stream``, one in six opening
    20 spans) of 0-500 bytes in one batch of width 512."""
    rng = random.Random(11)
    raws = [tc.chat_stream(i, rng.randint(0, 500), rng,
                           None if i % 6 else 20) for i in range(24)]
    assert_batch_equals_jax(raws, *tc.STREAM_DELIMS, enum, 512)


@pytest.mark.parametrize("delims", [("<o>", "</o>", "<h>", "</h>"),
                                    ("é", "✓", "", ""),
                                    ("", "", "🎉", "☃")])
def test_non_ascii_equals_jax_byte_for_byte(delims):
    """Multi-byte text and delimiters, and streams cut inside a character:
    the same bytes as JAX; the host call decodes with 'replace' as JAX's
    does."""
    raws = ["héllo <o>wörld ✓</o> tail ☃", "<o>日本語</o><o>ü<h>秘密</h>x</o>",
            "🎉<o>🎉é🎉</o>🎉<o>☃✓", "é<o>aé✓</o>é✓"]
    data = [r.encode() for r in raws] + [raws[0].encode()[:9],
                                         raws[1].encode()[:-2]]
    for enum in (False, True):
        assert_batch_equals_jax(data, *delims, enum)
    for raw in raws:
        assert_host_calls_agree(raw, *delims, True)
    cut = data[-1].decode("utf-8", "replace")
    assert fk.filter_chat_host(cut, *delims, False, device="cpu") == \
        jfk.filter_chat_host(cut, *delims, False)


def test_hide_start_without_stop_follows_the_jax_kernel():
    """With hide_start set and hide_stop empty the JAX kernel skips the
    hide pass (ops/filter_kernel.py:234) while the host InvertedFilter
    hides everything after hide_start: the port follows the JAX kernel."""
    args = ("a<h>b", "", "", "<h>", "", False)
    assert host_filter(*args, chunk=1) == (["a<h>b"], "a")
    assert jfk.filter_chat_host(*args) == (["a<h>b"], "a<h>b")
    assert fk.filter_chat_host(*args, device="cpu") == (["a<h>b"], "a<h>b")
    assert_batch_equals_jax(["a<h>b", "<o>x<h>y</o>"], "<o>", "</o>", "<h>",
                            "", True)


def test_dispatch_by_the_rows_device():
    """CPU rows run the plain version and count it; a device with no
    kernel raises."""
    bufs, lengths = rows(["<o>a</o>"])
    with EVENTS.recording() as rec:
        fk.filter_chat_text(bufs, lengths, start="<o>", stop="</o>",
                            hide_start="", hide_stop="",
                            enumerate_outputs=False)
    assert rec.counters == {"plain.chat_filter": 1}
    with pytest.raises(ValueError, match="no chat filter"):
        fk.filter_chat_text(bufs.to("meta"), lengths.to("meta"), start="<o>",
                            stop="</o>", hide_start="", hide_stop="",
                            enumerate_outputs=False)
    with pytest.raises(ValueError, match="uint8"):
        fk.filter_chat_text(bufs.int(), lengths, start="<o>", stop="</o>",
                            hide_start="", hide_stop="",
                            enumerate_outputs=False)


def test_host_call_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fk.filter_chat_host("<o>a</o>", "<o>", "</o>", "", "", False)


# ---- the chat service ---------------------------------------------------------

@pytest.fixture
def filters_on_the_cpu(monkeypatch):
    """The service's ``filter_chat_host`` call runs the plain version."""
    monkeypatch.setattr(fk.filter_chat_host, "__kwdefaults__",
                        {"device": "cpu"})


def run_port_chat(monkeypatch, text, flag: bool, **kw):
    from interpolation_engine_tpu_torch.chat.service import run_chat
    if flag:
        monkeypatch.setenv("IE_TPU_DEVICE_FILTERS", "1")
    else:
        monkeypatch.delenv("IE_TPU_DEVICE_FILTERS", raising=False)
    with tc.sse_server(lambda body: text) as server:
        io = port.io_manager.IOManager(port.io_manager.BufferBackend())
        outputs, visual = asyncio.run(run_chat(
            io, messages=[{"role": "user", "content": "hi"}],
            completion_args={"model": "m"}, api_url=server.url, **kw))
    return outputs, visual, io.output_text


@pytest.mark.parametrize("flag", [True, False])
def test_service_filters_equal_with_the_flag_on_and_off(
        flag, monkeypatch, filters_on_the_cpu):
    """tests/test_chat.py's fast-path test on the port's service: with
    IE_TPU_DEVICE_FILTERS=1 one filter call replaces the per-chunk state
    machines, with the same outputs and visual text."""
    text = ("<think>hidden plan</think>junk <output>first</output> mid "
            "<output>second</output> tail")
    with EVENTS.recording() as rec:
        got = run_port_chat(monkeypatch, text, flag, start_str="<output>",
                            stop_str="</output>", n_outputs=2,
                            hide_start_str="<think>",
                            hide_stop_str="</think>")
    assert got == (["first", "second"], "1. first\n\n2. second",
                   "1. first\n\n2. second")
    assert rec.counters.get("plain.chat_filter", 0) == flag


@pytest.mark.parametrize("flag", [True, False])
def test_service_hidden_and_overflowing_chats(flag, monkeypatch,
                                              filters_on_the_cpu):
    """``shown: false`` writes nothing; 18 spans take the exact oracle
    with the flag on, and equal the incremental filters with it off."""
    text = "".join(f"<s>{k}<t>x</t></s>" for k in range(18))
    with EVENTS.recording() as rec:
        outputs, visual, written = run_port_chat(
            monkeypatch, text, flag, start_str="<s>", stop_str="</s>",
            n_outputs=3, hide_start_str="<t>", hide_stop_str="</t>")
    assert outputs == [f"{k}<t>x</t>" for k in range(18)]
    assert visual == written == "\n\n".join(f"{k + 1}. {k}"
                                            for k in range(18))
    assert rec.counters.get("host.chat_filter", 0) == flag
    assert run_port_chat(monkeypatch, text, flag, start_str="<s>",
                         stop_str="</s>", shown=False)[1:] == ("", "")


# ---- chat programs through the port's engines --------------------------------

def host_run(src: str, tmp_path) -> dict:
    """The JAX package's host runtime, incremental filters (the oracle)."""
    path = tmp_path / "host.json5"
    path.write_text(src)
    with pytest.MonkeyPatch.context() as m:
        m.delenv("IE_TPU_DEVICE_FILTERS", raising=False)
        state = asyncio.run(async_main(str(path), [],
                                       IOManager(BufferBackend())))
    return {"output": state["output"], "inserts": dict(state["inserts"])}


def port_io(i=None):
    return port.io_manager.IOManager(port.io_manager.BufferBackend())


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("engine", ["turbo", "general"])
@pytest.mark.parametrize("name", sorted(tc.CHAT_PROGRAMS))
def test_chat_program_on_the_engines_equals_the_host(
        name, engine, flag, tmp_path, monkeypatch, capsys,
        filters_on_the_cpu):
    """8 instances to DONE, each equal to the host; on the turbo engine
    every chat parks through the exact ring (no escape), and with the flag
    on each chat call is one filter call."""
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    from interpolation_engine_tpu_torch.vm.turbo import (TurboConfig,
                                                         TurboEngine)
    with tc.sse_server() as server:
        src = tc.chat_program(name, server.url)
        host = host_run(src, tmp_path)
        calls = len(server.requests)
        if flag:
            monkeypatch.setenv("IE_TPU_DEVICE_FILTERS", "1")
        with EVENTS.recording() as rec:
            if engine == "turbo":
                eng = TurboEngine(compile_port(src),
                                  TurboConfig(**tc.CHAT_SIZES),
                                  io_factory=port_io, device="cpu")
                results = eng.results(eng.run(eng.make_batch(8)))
                assert eng.ring_stats["escapes"] == 0
                assert eng.ring_stats["parks_by_kind"][
                    port.vm_config.PARK_CHAT] == len(server.requests) - calls
            else:
                runner = DeviceRunner(compile_port(src), io_factory=port_io,
                                      device="cpu")
                results = runner.results(
                    runner.run(runner.make_instances(8)))
        chats = len(server.requests) - calls
    capsys.readouterr()
    assert chats == 8 * (3 if name == "turns" else 4)
    assert rec.counters.get("plain.chat_filter", 0) == chats * flag
    for r in results:
        assert (r.output, r.inserts) == (host["output"], host["inserts"])


@pytest.mark.parametrize("turbo", ["1", "0"])
@pytest.mark.parametrize("name", sorted(tc.CHAT_PROGRAMS))
def test_chat_program_through_run_program_on_device(
        name, turbo, tmp_path, monkeypatch, capsys, filters_on_the_cpu):
    """The CLI's device entry point at batch 4, the turbo engine
    (IE_TPU_TURBO=1, its default widths: values past them escape) and the
    general engine (IE_TPU_TURBO=0), with the filter on: instance 0 prints
    what the host prints."""
    from interpolation_engine_tpu_torch.vm.driver import run_program_on_device
    monkeypatch.setenv("IE_TPU_TURBO", turbo)
    with tc.sse_server() as server:
        src = tc.chat_program(name, server.url)
        host = host_run(src, tmp_path)
        path = tmp_path / "device.json5"
        path.write_text(src)
        capsys.readouterr()
        monkeypatch.setenv("IE_TPU_DEVICE_FILTERS", "1")
        port.loader.invalidate_cache()
        assert run_program_on_device(str(path), [], port_io(), batch=4,
                                     device="cpu") == 0
    assert capsys.readouterr().out == host["output"].strip() + "\n"
