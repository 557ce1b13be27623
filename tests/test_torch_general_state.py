"""The general engine's byte strings, store and codecs (the port's
``vm/bytestr.py`` and ``vm/state.py``) against the JAX package's, on
seeded numpy inputs: every batched helper against the JAX one under
``vmap``, out-of-range offsets and lengths included (``lax.dynamic_slice``
and JAX gathers clamp, torch indexing does not), the store's operations
on random sequences, and the host codecs field by field."""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_helpers import GEN_CFG

from interpolation_engine_tpu.vm import bytestr as jbs
from interpolation_engine_tpu.vm import state as jst
from interpolation_engine_tpu_torch.vm import bytestr as pbs
from interpolation_engine_tpu_torch.vm import state as pst

ROWS = 96
W = 24
ALPHABET = np.frombuffer(b"ab{}\\ 0123456789-+", np.uint8)


def rand_bufs(rng, rows=ROWS, width=W):
    """Random rows, bytes past any length left non-zero on purpose."""
    return ALPHABET[rng.integers(0, len(ALPHABET), (rows, width))]


def ints(rng, lo, hi, rows=ROWS):
    return rng.integers(lo, hi + 1, rows).astype(np.int32)


def vjax(fn, *args, axes=0):
    """fn under jit(vmap) over numpy arguments, back to numpy."""
    out = jax.jit(jax.vmap(fn, in_axes=axes))(*[jnp.asarray(a)
                                                for a in args])
    return jax.tree.map(np.asarray, out)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def same(port_out, jax_out):
    port_out = port_out if isinstance(port_out, tuple) else (port_out,)
    jax_out = jax_out if isinstance(jax_out, tuple) else (jax_out,)
    assert len(port_out) == len(jax_out)
    for k, (p, j) in enumerate(zip(port_out, jax_out)):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        np.testing.assert_array_equal(p, np.broadcast_to(j, p.shape),
                                      err_msg=f"output {k}")


# ---------------------------------------------------------------------------
# vm/bytestr.py: one case per helper; offsets and shifts run past both ends
# ---------------------------------------------------------------------------

def case_shifts(rng):
    b, k = rand_bufs(rng), ints(rng, -2 * W, 2 * W)
    for name in ("shift_right", "shift_left", "shift_any"):
        same(getattr(pbs, name)(t(b), t(k)), vjax(getattr(jbs, name), b, k))


def case_window(rng):
    """Every JAX site clips the start to [0, width - size] before
    ``lax.dynamic_slice`` (state.py:194, interp_kernel.py:130,
    step.py:303), which clamps a start past the end by itself but wraps a
    negative one; the port's window is that pair."""
    b, off = rand_bufs(rng), ints(rng, -W, 2 * W)
    for size in (1, 8, W):
        same(pbs.window(t(b), t(off), size), vjax(
            lambda x, o: jax.lax.dynamic_slice(
                x, (jnp.clip(o, 0, W - size),), (size,)), b, off))
        big = np.maximum(off, 0)
        same(pbs.window(t(b), t(big), size), vjax(
            lambda x, o: jax.lax.dynamic_slice(x, (o,), (size,)), b, big))


def case_from_table(rng):
    table = rand_bufs(rng, 1, 40)[0]
    off, ln = ints(rng, -5, 60), ints(rng, -2, 20)
    for size in (8, 16):
        same(pbs.from_table(t(table), t(off), t(ln), size),
             vjax(lambda o, n: jbs.from_table(jnp.asarray(table), o, n,
                                              size), off, ln))


def case_normalize_equal(rng):
    b, ln = rand_bufs(rng), ints(rng, -2, W + 2)
    same(pbs.normalize(t(b), t(ln)), vjax(jbs.normalize, b, ln))
    a = jbs_norm(b, ln)
    c = a.copy()
    c[::3] = jbs_norm(rand_bufs(rng), ln)[::3]
    same(pbs.equal(t(a), t(ln), t(c), t(ln)), vjax(jbs.equal, a, ln, c, ln))


def jbs_norm(b, ln):
    return vjax(jbs.normalize, b, ln)


def case_substring(rng):
    b, start, ln = rand_bufs(rng), ints(rng, -3, W + 3), ints(rng, -3, W + 3)
    for out in (W - 4, W, W + 8):
        same(pbs.substring(t(b), t(start), t(ln), out),
             vjax(lambda x, s, n: jbs.substring(x, s, n, out), b, start, ln))


def case_concat(rng):
    a, b = rand_bufs(rng), rand_bufs(rng, width=W // 2)
    al, bl = ints(rng, 0, W), ints(rng, 0, W // 2)
    for out in (W, W + W // 2):
        same(pbs.concat(t(a), t(al), t(b), t(bl), out),
             vjax(lambda *x: jbs.concat(*x, out), a, al, b, bl))


def case_splice(rng):
    b, rep = rand_bufs(rng), rand_bufs(rng, width=W // 2)
    ln = ints(rng, 0, W)
    start = (rng.random(ROWS) * (ln + 1)).astype(np.int32)
    end = start + (rng.random(ROWS) * (ln - start + 1)).astype(np.int32)
    rl = ints(rng, 0, W // 2)
    for out in (W, W + 6):
        same(pbs.splice(t(b), t(ln), t(start), t(end), t(rep), t(rl), out),
             vjax(lambda *x: jbs.splice(*x, out), b, ln, start, end, rep,
                  rl))


def case_find_count(rng):
    b, ln, st = rand_bufs(rng), ints(rng, -2, W + 2), ints(rng, -2, W + 2)
    hid = pbs.escape_hidden_mask(t(b), t(ln))
    same(hid, vjax(jbs.escape_hidden_mask, b, ln))
    for byte in (jbs.BRACE_OPEN, jbs.BRACE_CLOSE, ord("a")):
        for mask in (None, hid):
            jm = None if mask is None else mask.numpy()

            def jfind(x, n, s, m=None, byte=byte):
                return jbs.find(x, n, byte, s, m)

            def jrfind(x, n, m=None, byte=byte):
                return jbs.rfind(x, n, byte, m)

            def jcount(x, n, m=None, byte=byte):
                return jbs.count(x, n, byte, m)
            extra = () if mask is None else (jm,)
            same(pbs.find(t(b), t(ln), byte, t(st), mask),
                 vjax(jfind, b, ln, st, *extra))
            same(pbs.rfind(t(b), t(ln), byte, mask),
                 vjax(jrfind, b, ln, *extra))
            same(pbs.count(t(b), t(ln), byte, mask),
                 vjax(jcount, b, ln, *extra))


def case_int_to_bytes(rng):
    v = rng.integers(-2 ** 31, 2 ** 31, ROWS, dtype=np.int64)
    v[:8] = [0, -1, 1, 2 ** 31 - 1, -2 ** 31, 10, -10, 1000000000]
    v = v.astype(np.int32)
    v[8:40] = (v[8:40] % 2000) - 1000
    same(pbs.int_to_bytes(t(v), W), vjax(lambda x: jbs.int_to_bytes(x, W),
                                         v))


def case_bytes_to_int(rng):
    """Digits, signs, non-digits, and values past 32 bits (the JAX
    package's uint32 Horner sum wraps)."""
    digits = np.frombuffer(b"0123456789", np.uint8)
    b = digits[rng.integers(0, 10, (ROWS, W))]
    b[::4, 0] = ord("-")
    b[1::4, 0] = ord("+")
    b[2::8, 3] = ord("x")
    ln = ints(rng, 0, W)
    ln[:6] = [0, 1, 11, 20, W, W]
    same(pbs.bytes_to_int(t(b), t(ln)), vjax(jbs.bytes_to_int, b, ln))


def case_unescape_escape(rng):
    b, ln = rand_bufs(rng), ints(rng, 0, W)
    nb = jbs_norm(b, ln)
    same(pbs.unescape_braces(t(nb), t(ln)), vjax(jbs.unescape_braces, nb, ln))
    for out in (W, 2 * W):
        same(pbs.escape_braces(t(nb), t(ln), out),
             vjax(lambda x, n: jbs.escape_braces(x, n, out), nb, ln))


BYTESTR_CASES = {name[5:]: fn for name, fn in sorted(globals().items())
                 if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(BYTESTR_CASES))
def test_bytestr_equals_jax(name):
    BYTESTR_CASES[name](np.random.default_rng(zlib.crc32(name.encode())))


def test_window_clamps_where_torch_would_not():
    """The clamp is explicit: a start past the end reads the last window,
    a negative start the first (torch would raise or wrap)."""
    b = t(np.arange(10, dtype=np.uint8)[None].repeat(3, 0))
    got = pbs.window(b, t(np.array([-4, 3, 99], np.int32)), 4)
    assert got.tolist() == [[0, 1, 2, 3], [3, 4, 5, 6], [6, 7, 8, 9]]


# ---------------------------------------------------------------------------
# vm/state.py: hash, store operations, codecs
# ---------------------------------------------------------------------------

def test_fnv1a_is_uint32_arithmetic():
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, (ROWS, 40)).astype(np.uint8)
    ln = ints(rng, -1, 42)
    got = pst.fnv1a(t(b), t(ln))
    want = vjax(jst.fnv1a, b, ln)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert (want >= 2 ** 31).any() and (want < 2 ** 31).any()
    for i in range(8):
        assert int(got[i]) == int(pst.fnv1a_np(bytes(b[i, :max(ln[i], 0)])))


def rand_value(rng, depth=0):
    r = rng.random()
    if r < 0.4:
        return int(rng.integers(-2 ** 31, 2 ** 31))
    if r < 0.8 or depth:
        n = int(rng.integers(0, 12))
        return "".join(rng.choice(list("ab{}\\ xyé"), n))
    return [rand_value(rng, 1) for _ in range(int(rng.integers(0, 5)))]


def rand_inserts(rng, n_keys):
    return {"".join(rng.choice(list("kqz_"), int(rng.integers(1, 6))))
            + str(i): rand_value(rng) for i in range(n_keys)}


def jax_row(inst) -> dict:
    return {k: np.asarray(v) for k, v in inst._asdict().items()}


def assert_same_row(p: dict, j: dict, where=""):
    assert set(p) == set(j)
    for k in j:
        assert np.asarray(p[k]).dtype == j[k].dtype, (where, k)
        np.testing.assert_array_equal(p[k], j[k], err_msg=f"{where} {k}")


def test_codecs_equal_jax_field_by_field():
    rng = np.random.default_rng(11)
    cfg = GEN_CFG
    for trial in range(12):
        inserts = rand_inserts(rng, int(rng.integers(0, cfg.n_slots // 2)))
        kw = dict(output="".join(rng.choice(list("ab\n{é"), int(
                      rng.integers(0, 30)))),
                  pc=int(rng.integers(0, 50)),
                  counters=list(rng.integers(0, 9, int(rng.integers(0, 4)))),
                  rng=int(rng.integers(0, 2 ** 32)),
                  steps=int(rng.integers(0, 1000)))
        p = pst.encode_instance(inserts, cfg, **kw)
        j = jax_row(jst.encode_instance(inserts, cfg, **kw))
        assert_same_row(p, j, f"trial {trial}")
        assert pst.decode_inserts(p) == jst.decode_inserts(
            jst.VMInstance(**j)) == inserts
        assert pst.decode_output(p) == kw["output"]
        assert_same_row(pst.encode_inserts(inserts, cfg, seed=trial),
                        jax_row(jst.encode_inserts(inserts, cfg, seed=trial)))


CODEC_ERRORS = {
    "slots": ({f"k{i}": i for i in range(13)}, ""),
    "key_length": ({"k" * 25: 1}, ""),
    "arena": ({"k": "v" * 1030}, ""),
    "pool": ({"k": list(range(33))}, ""),
    "bool": ({"k": True}, ""),
    "bool_element": ({"k": [False]}, ""),
    "dict": ({"k": {"a": 1}}, ""),
    "nested_list": ({"k": [[1]]}, ""),
    "output": ({"k": 1}, "o" * 193),
    "past_int32": ({"k": 2 ** 40}, ""),
}


@pytest.mark.parametrize("case", sorted(CODEC_ERRORS))
def test_codec_errors_are_the_jax_errors(case):
    """The same error class (by name: each package has its own
    HostCodecError) with the same message."""
    inserts, output = CODEC_ERRORS[case]
    with pytest.raises(Exception) as jerr:
        jst.encode_instance(inserts, GEN_CFG, output=output)
    with pytest.raises(Exception) as perr:
        pst.encode_instance(inserts, GEN_CFG, output=output)
    assert type(perr.value).__name__ == type(jerr.value).__name__
    assert str(perr.value) == str(jerr.value)


def test_from_jax_and_back_keeps_every_field():
    rng = np.random.default_rng(5)
    rows = [jax_row(jst.encode_instance(rand_inserts(rng, 4), GEN_CFG,
                                        rng=2 ** 32 - 1 - i))
            for i in range(3)]
    stacked = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    batch = pst.from_jax(stacked)
    assert batch.key_hash.dtype == batch.rng.dtype == torch.int64
    assert_same_row(batch.to_numpy(), stacked)
    assert_same_row(pst.stack_rows(rows).to_numpy(), stacked)
    one = pst.broadcast_row(rows[0], 4)
    assert_same_row(pst.row_of(one.to_numpy(), 3), rows[0])


class StoreOps:
    """The store operations of both packages on one batch of rows."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.j_set = jax.jit(jax.vmap(
            lambda st, kb, kl, vt, vi, vo, vl: jst.store_set(
                st, kb, kl, vt, vi, vo, vl, cfg)))
        self.j_write = jax.jit(jax.vmap(
            lambda st, b, ln: jst.arena_write(st, b, ln, cfg)))
        self.j_find = jax.jit(jax.vmap(jst.find_slot))
        self.j_delete = jax.jit(jax.vmap(jst.store_delete))
        self.j_read = jax.jit(jax.vmap(
            lambda st, off, ln: jst.arena_read(st, off, ln, cfg.max_str)))


def jax_batch(rows):
    return jst.VMInstance(**{k: jnp.stack([r[k] for r in rows])
                             for k in rows[0]})


def test_store_operations_equal_jax_on_random_sequences():
    """store_set / arena_write / find_slot / store_delete / arena_read on
    40 random operations over 24 rows with their own stores: new and
    existing keys, arena and slot overflow, lengths past the payload, slots
    out of range. Every field after every operation."""
    cfg = GEN_CFG
    ops = StoreOps(cfg)
    rng = np.random.default_rng(21)
    R, MS = 24, cfg.max_str
    rows = [pst.encode_inserts(rand_inserts(rng, int(rng.integers(0, 6))),
                               cfg) for _ in range(R)]
    jb = jax_batch(rows)
    pb = pst.stack_rows(rows)
    names = [b"k0", b"q1", b"zz2", b"new", b"other", b"x" * 24, b""]
    for step in range(40):
        op = rng.choice(["set", "write", "find", "delete", "read"])
        keys = np.zeros((R, MS), np.uint8)
        klen = np.zeros((R,), np.int32)
        for r in range(R):
            name = names[rng.integers(0, len(names))]
            keys[r, :len(name)] = list(name)
            klen[r] = len(name)
        if op == "set":
            # value spans stay inside the pool, so rows still decode
            vals = [ints(rng, 1, 3, R), ints(rng, -9, 9, R),
                    ints(rng, 0, 16, R), ints(rng, 0, 12, R)]
            jb, jov = ops.j_set(jb, jnp.asarray(keys), jnp.asarray(klen),
                                *map(jnp.asarray, vals))
            pb, pov = pst.store_set(pb, t(keys), t(klen), *map(t, vals),
                                    cfg)
            same(pov, np.asarray(jov))
        elif op == "write":
            buf = rand_bufs(rng, R, MS)
            ln = ints(rng, 0, MS + 8, R)
            ln[::5] = 400                         # fills the arena
            jb, joff, jov = ops.j_write(jb, jnp.asarray(buf),
                                        jnp.asarray(ln))
            pb, poff, pov = pst.arena_write(pb, t(buf), t(ln), cfg)
            same((poff, pov), (np.asarray(joff), np.asarray(jov)))
        elif op == "find":
            same(pst.find_slot(pb, t(keys), t(klen)),
                 tuple(map(np.asarray, ops.j_find(jb, jnp.asarray(keys),
                                                  jnp.asarray(klen)))))
        elif op == "delete":
            slot = ints(rng, -1, cfg.n_slots, R)
            jb = ops.j_delete(jb, jnp.asarray(slot))
            pb = pst.store_delete(pb, t(slot))
        else:
            off = ints(rng, -10, cfg.arena_size + 10, R)
            ln = ints(rng, 0, MS, R)
            same(pst.arena_read(pb, t(off), t(ln), MS),
                 tuple(map(np.asarray, ops.j_read(jb, jnp.asarray(off),
                                                  jnp.asarray(ln)))))
        assert_same_row(pb.to_numpy(), jax_row(jb), f"step {step} {op}")
        for r in range(0, R, 7):
            assert pst.decode_inserts(pst.row_of(pb.to_numpy(), r)) == \
                jst.decode_inserts(jax.tree.map(lambda a: a[r], jb))


def test_colliding_hash_is_reported_not_aliased():
    """Two keys with one hash and length: the first candidate's bytes
    decide; a probe matching neither is a collision, and store_set writes
    nothing and reports an overflow, as in JAX. An empty store gives slot
    0 (argmax of all-False) with found False."""
    cfg = GEN_CFG
    row = pst.encode_inserts({"ab": 1, "cd": 2}, cfg)
    row["key_hash"][0] = row["key_hash"][1]        # "ab" under H("cd")
    empty = pst.encode_inserts({}, cfg)
    rows = [row, row, empty]
    ops = StoreOps(cfg)
    keys = np.zeros((3, cfg.max_str), np.uint8)
    for r, name in enumerate([b"cd", b"ab", b"ab"]):
        keys[r, :2] = list(name)
    klen = np.full((3,), 2, np.int32)
    got = pst.find_slot(pst.stack_rows(rows), t(keys), t(klen))
    same(got, tuple(map(np.asarray, ops.j_find(
        jax_batch(rows), jnp.asarray(keys), jnp.asarray(klen)))))
    found, slot, collide = (x.tolist() for x in got)
    assert found == [False] * 3 and collide == [True, False, False]
    assert slot == [0, 0, 0]
    vals = [np.full((3,), v, np.int32) for v in (1, 5, 0, 0)]
    pb, pov = pst.store_set(pst.stack_rows(rows), t(keys), t(klen),
                            *map(t, vals), cfg)
    jb, jov = ops.j_set(jax_batch(rows), jnp.asarray(keys),
                        jnp.asarray(klen), *map(jnp.asarray, vals))
    same(pov, np.asarray(jov))
    assert_same_row(pb.to_numpy(), jax_row(jb), "collision")
    assert pov.tolist() == [True, False, False]
