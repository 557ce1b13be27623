"""The port's interpolation and wildcard-match kernels (``ops/interp_kernel.py``,
``ops/match_kernel.py``) against the JAX package's under ``vmap``, field
for field, and against the host oracle wherever the device does not defer
to the host. Each row carries its own store; inputs from a numpy seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_interp_kernel as tik
from torch_helpers import GEN_CFG

from interpolation_engine_tpu.ops import interp_kernel as jik
from interpolation_engine_tpu.ops import match_kernel as jmk
from interpolation_engine_tpu.vm import state as jst
from interpolation_engine_tpu_torch.ops import brace_scan as scan_mod
from interpolation_engine_tpu_torch.ops import interp_kernel as ik
from interpolation_engine_tpu_torch.ops import match_kernel as mk
from interpolation_engine_tpu_torch.vm import state as pst

CFG = tik.CFG     # the JAX package's interpolation test config


def encode_rows(cases, cfg):
    """(port batch, JAX batch, bufs, lengths) for (inserts, content)
    pairs: one row and one store per pair."""
    rows = [pst.encode_inserts(ins, cfg) for ins, _ in cases]
    bufs = np.zeros((len(cases), cfg.max_str), np.uint8)
    lens = np.zeros((len(cases),), np.int32)
    for i, (_, content) in enumerate(cases):
        data = content.encode()
        bufs[i, :min(len(data), cfg.max_str)] = list(data[:cfg.max_str])
        lens[i] = len(data)
    jb = jst.VMInstance(**{k: jnp.stack([r[k] for r in rows])
                           for k in rows[0]})
    return pst.stack_rows(rows), jb, bufs, lens


def both(cases, cfg=CFG):
    """The port's and JAX's InterpResult for every case, as numpy."""
    pb, jb, bufs, lens = encode_rows(cases, cfg)
    port = ik.interpolate(pb, torch.from_numpy(bufs), torch.from_numpy(lens),
                          cfg)
    jax_res = jax.jit(jax.vmap(lambda st, b, n: jik.interpolate(
        st, b, n, cfg)))(jb, jnp.asarray(bufs), jnp.asarray(lens))
    for name, p, j in zip(ik.InterpResult._fields, port, jax_res):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j),
                                      err_msg=name)
    return port, pb


def decode(res, pb, i):
    """One row's result as tests/test_interp_kernel.py's
    device_interpolate reads it."""
    err = int(res.err[i])
    if err == ik.ERR_MISSING:
        return ("raise", "interp")
    if err == ik.ERR_ASSERT:
        return ("raise", "assert")
    if err in (ik.ERR_CAPACITY, ik.ERR_HOST):
        return ("host",)
    vtype = int(res.vtype[i])
    if vtype == pst.T_INT:
        return ("ok", int(res.vint[i]))
    if vtype == pst.T_STR:
        return ("ok", bytes(res.buf[i, :int(res.length[i])].tolist()
                            ).decode("utf-8", "replace"))
    row = pst.row_of(pb.to_numpy(), i)
    row["vtype"] = np.array([pst.T_LIST])
    row["voff"] = np.array([int(res.pool_off[i])])
    row["vlen"] = np.array([int(res.pool_len[i])])
    row["occ"], row["key_off"], row["key_len"] = (
        np.array([True]), np.array([0]), np.array([0]))
    return ("ok", pst.decode_inserts(row)[""])


def check_with_host(cases, res, pb) -> int:
    checked = 0
    for i, (inserts, content) in enumerate(cases):
        dev = decode(res, pb, i)
        if dev == ("host",):
            continue
        assert dev == tik.host_interpolate(inserts, content), (inserts,
                                                               content)
        checked += 1
    return checked


def test_cases_equal_jax_and_host():
    res, pb = both(tik.CASES)
    assert check_with_host(tik.CASES, res, pb) >= 20


def test_fuzz_equals_jax_and_host():
    """400 random templates over ``ab{}\\y `` against 400 random stores."""
    rng = np.random.default_rng(321)
    cases = []
    for _ in range(400):
        inserts = {}
        for k in ("a", "b", "ab", "y"):
            r = rng.random()
            if r < 0.55:
                inserts[k] = "".join(rng.choice(list("AB{}\\c"),
                                                int(rng.integers(0, 5))))
            elif r < 0.75:
                inserts[k] = int(rng.integers(-9, 100))
        cases.append((inserts, "".join(rng.choice(
            list("ab{}\\y "), int(rng.integers(0, 13))))))
    res, pb = both(cases)
    assert check_with_host(cases, res, pb) > 300


# error precedence in the substitution loop (interp_kernel.py:181-186) and
# the cap rule (:196-200), at max_subst 2
PRECEDENCE = [
    ({"a": "x"}, "{a}{a}", ik.ERR_OK),
    ({"a": "x"}, "{a}{a}{a}", ik.ERR_HOST),           # braces left at the cap
    ({"a": "x"}, "{zz}{a}{a}", ik.ERR_HOST),          # the cap before a miss
    ({"a": "x"}, "{zz}{a}", ik.ERR_MISSING),          # rightmost first
    ({"a": "x"}, "{a}}", ik.ERR_ASSERT),              # unbalanced first
    ({"a": "x"}, "{zz}}", ik.ERR_ASSERT),
    ({"l": ["p"], "a": "x"}, "{a}{l}", ik.ERR_HOST),  # a list as text
    ({"l": ["p"]}, "{zz}{l}", ik.ERR_HOST),
    ({"a": "x" * 60}, "{a}{a}", ik.ERR_CAPACITY),     # past max_str
    ({"a": "x"}, "a" * 100, ik.ERR_CAPACITY),         # template cut on load
    ({"a": "x"}, "}{", ik.ERR_OK),                    # no '}' after the '{'
    ({}, "{HH:MM}", ik.ERR_HOST),
    ({"n": "k", "k": 3}, "{{n}}", ik.ERR_OK),
    ({"n": "k", "k": 3, "m": 4}, "{{m}}", ik.ERR_MISSING),
    ({"l": ["k"]}, "{{l}}", ik.ERR_ASSERT),
    ({"n": "k"}, "{{{n}}}", ik.ERR_HOST),
]


def test_error_precedence_and_cap_equal_jax():
    cfg = jst.VMConfig(max_str=64, max_key=24, n_slots=8, arena_size=512,
                       pool_size=8, out_size=64, max_subst=2)
    res, _ = both([(ins, c) for ins, c, _ in PRECEDENCE], cfg)
    assert res.err.tolist() == [e for _, _, e in PRECEDENCE]


def test_brace_scan_runs_once_per_iteration_on_live_rows(monkeypatch):
    """One scan per loop iteration, over the rows still substituting; the
    JAX loop scanned each row twice per iteration."""
    calls = []
    real = scan_mod.brace_scan

    def counted(bufs, lengths):
        calls.append(bufs.shape[0])
        return real(bufs, lengths)

    monkeypatch.setattr(scan_mod, "brace_scan", counted)
    cases = [({"a": "x"}, "plain"), ({"a": "x"}, "x{a}"),
             ({"a": "x"}, "x{a}{a}{a}")]
    res, pb = both(cases)
    assert calls == [3, 2, 1, 1]
    assert [decode(res, pb, i) for i in range(3)] == [
        ("ok", "plain"), ("ok", "xx"), ("ok", "xxxx")]


def test_simple_key_span_equals_jax():
    rng = np.random.default_rng(9)
    n = 32
    bufs = np.frombuffer(b"ab{}\\", np.uint8)[rng.integers(0, 5, (300, n))]
    lens = rng.integers(-1, n + 2, 300).astype(np.int32)
    got = ik.simple_key_span(torch.from_numpy(bufs), torch.from_numpy(lens))
    want = jax.jit(jax.vmap(jik.simple_key_span))(jnp.asarray(bufs),
                                                  jnp.asarray(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


# ---------------------------------------------------------------------------
# wildcard_match
# ---------------------------------------------------------------------------

def pack(strings, width):
    bufs = np.zeros((len(strings), width), np.uint8)
    lens = np.zeros((len(strings),), np.int32)
    for i, s in enumerate(strings):
        data = s.encode()
        bufs[i, :len(data)] = list(data)
        lens[i] = len(data)
    return bufs, lens


def match_both(pats, subjs, max_stars, shared=False):
    width = 48
    pb, pl = pack(pats, width)
    sb, sl = pack(subjs, width)
    got = mk.wildcard_match(*map(torch.from_numpy, (pb, pl, sb, sl)),
                            max_stars)
    axes = (None, None, 0, 0) if shared else 0
    if shared:
        pb, pl = pb[0], pl[0]
    want = jax.jit(jax.vmap(lambda p, n, s, m: jmk.wildcard_match(
        p, n, s, m, max_stars), in_axes=axes))(*map(jnp.asarray,
                                                    (pb, pl, sb, sl)))
    for name, g, w in zip(mk.MatchResult._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("max_stars", [2, 3])
def test_wildcard_match_fuzz_equals_jax(max_stars):
    rng = np.random.default_rng(40 + max_stars)
    pats = ["".join(rng.choice(list("ab**\n"), int(rng.integers(0, 9))))
            for _ in range(500)]
    subjs = ["".join(rng.choice(list("aab\n"), int(rng.integers(0, 17))))
             for _ in range(500)]
    pats[:4] = ["a" * 33, "*" + "b" * 33, "", "*"]
    subjs[4:8] = ["ab\n", "ab\n\n", "\n", "a\nb\n"]
    pats[4:8] = ["ab", "ab", "", "a*b"]   # the trailing-newline end anchor
    got = match_both(pats, subjs, max_stars)
    assert got.ok.any() and not got.ok.all()
    assert not got.supported[:2].any() and got.supported[2:4].all()
    assert got.ok[4:8].tolist() == [True, False, True, True]


def test_wildcard_match_shared_pattern_equals_jax():
    rng = np.random.default_rng(8)
    subjs = ["".join(rng.choice(list("xyz-"), int(rng.integers(0, 12))))
             for _ in range(200)]
    for pat in ("x*-*", "*y", "xyz", "*"):
        match_both([pat] * len(subjs), subjs, GEN_CFG.max_stars, shared=True)
