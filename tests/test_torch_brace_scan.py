"""The brace scan's plain version (``ops/brace_scan.py``, what the CPU runs
and what the CUDA kernel is held against on the card) against the JAX
package's brace scan: the Pallas kernel in interpret mode, batched
(``brace_scan_pallas``) and per string (``_scan_call_one``), and its jnp
reference. Bit for bit; inputs from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interpolation_engine_tpu.ops import pallas_scan as jax_scan
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import brace_scan as scan

# tests/test_pallas_scan.py's curated strings
CURATED = [
    "plain", "{a}", "x{a}y", "{a}{b}", "{q-{i}}", r"\{a\}",
    r"{a} \{b\}", "unbalanced {", "}{", "", "{}", "a}b{c",
    r"esc\{only", "{outer{inner}rest}",
]
# a brace at 0, an escape at the end, an escaped backslash, runs
EDGES = ["{", "}", "\\{", "a\\{", "{a\\}", "\\\\{", "{}{", "{{a}}",
         "\\" * 9 + "{", "}}}{{{", "{" * 20 + "}" * 19]


def make_rows(strings, ms, tail=b"", lengths=None):
    """Rows of ``ms`` bytes; ``tail`` is written past each string's length
    (bytes that must count for nothing)."""
    bufs = np.zeros((len(strings), ms), np.uint8)
    lens = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        data = s.encode()[:ms]
        row = (data + tail)[:ms]
        bufs[i, :len(row)] = list(row)
        lens[i] = len(data)
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
    return bufs, lens


def fuzz_rows(ms: int, n: int, seed: int):
    """n random rows over ``ab{}\\ `` filled to ms bytes (braces past the
    length), lengths over [-2, ms + 3]."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ab{}\\ ", np.uint8)
    bufs = alphabet[rng.integers(0, 6, (n, ms))]
    lens = rng.integers(-2, ms + 4, n).astype(np.int32)
    k = min(n, ms + 1)
    lens[:k] = np.arange(k)                # lengths 0.. once each
    return bufs, lens


def port(bufs, lens):
    return scan.brace_scan(torch.from_numpy(bufs.copy()),
                           torch.from_numpy(lens.copy())).numpy()


def jax_pallas(bufs, lens):
    return np.asarray(jax_scan.brace_scan_pallas(
        jnp.asarray(bufs), jnp.asarray(lens), interpret=True))


def jax_reference(bufs, lens):
    return np.asarray(jax_scan.brace_scan_reference(jnp.asarray(bufs),
                                                    jnp.asarray(lens)))


@pytest.mark.parametrize("tail", [b"", b"}{}{"])
def test_curated_equals_pallas_and_reference(tail):
    bufs, lens = make_rows(CURATED + EDGES, 128, tail)
    got = port(bufs, lens)
    np.testing.assert_array_equal(got, jax_pallas(bufs, lens))
    np.testing.assert_array_equal(got, jax_reference(bufs, lens))


@pytest.mark.parametrize("ms", [96, 128, 130])
def test_fuzz_equals_pallas_and_reference(ms):
    bufs, lens = fuzz_rows(ms, 600, seed=ms)
    got = port(bufs, lens)
    np.testing.assert_array_equal(got, jax_pallas(bufs, lens))
    np.testing.assert_array_equal(got, jax_reference(bufs, lens))
    # the fuzz reaches every outcome
    assert (got[:, 2] == -1).any() and (got[:, 2] >= 0).any()
    assert (got[:, 3] == -1).any() and (got[:, 3] >= 0).any()


def test_single_rows_equal_the_per_string_call():
    """B, the per-string Pallas call under the general loop, one row at a
    time."""
    bufs, lens = make_rows(CURATED + EDGES, 96, b"{}")
    fb, fl = fuzz_rows(96, 24, seed=7)
    bufs, lens = np.concatenate([bufs, fb]), np.concatenate([lens, fl])
    got = port(bufs, lens)
    for i in range(bufs.shape[0]):
        one = np.asarray(jax_scan._scan_call_one(
            jnp.asarray(bufs[i]), jnp.asarray(lens[i]), interpret=True))
        np.testing.assert_array_equal(got[i], one, err_msg=str(i))


def test_worked_values():
    bufs, lens = make_rows(["x{a}y{b}", "\\{a}", "}{", "{ab", "", "a\\{b}"],
                           32, b"{}")
    assert port(bufs, lens).tolist() == [
        [2, 2, 5, 7],     # the rightmost '{' and the '}' after it
        [0, 1, -1, 3],    # hidden '{'; inner_to is the first '}' anywhere
        [1, 1, 1, -1],    # no '}' after the last '{'
        [1, 0, 0, -1],
        [0, 0, -1, -1],   # nothing past the length counts
        [0, 1, -1, 4]]


def test_wrapper_runs_the_plain_version_on_cpu_tensors_only():
    """A CPU tensor goes to the plain version (the kernel's count does not
    move); anything the kernel cannot take raises."""
    bufs, lens = make_rows(CURATED, 64)
    b, ln = torch.from_numpy(bufs), torch.from_numpy(lens)
    with EVENTS.recording() as rec:
        scan.brace_scan(b, ln)
    assert rec.counters == {"plain.brace_scan": 1}
    with pytest.raises(ValueError, match="uint8"):
        scan.brace_scan(b.to(torch.int32), ln)
    with pytest.raises(ValueError, match="int32"):
        scan.brace_scan(b, ln.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        scan.brace_scan(b.t().contiguous().t(), ln)
    with pytest.raises(ValueError, match="rows"):
        scan.brace_scan(b, ln[:-1].contiguous())
    with pytest.raises(ValueError, match="meta"):
        scan.brace_scan(b.to("meta"), ln.to("meta"))


def test_empty_width_and_empty_batch():
    assert scan.brace_scan(torch.zeros((3, 0), dtype=torch.uint8),
                           torch.tensor([0, 2, -1], dtype=torch.int32)
                           ).tolist() == [[0, 0, -1, -1]] * 3
    assert scan.brace_scan(torch.zeros((0, 8), dtype=torch.uint8),
                           torch.zeros((0,), dtype=torch.int32)
                           ).shape == (0, 4)
