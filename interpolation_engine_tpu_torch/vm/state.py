"""The general engine's per-instance state: insert store, arena, list pool
and output buffer, batched over rows, with its host codecs.

The counterpart of ``interpolation_engine_tpu/vm/state.py``. ``VMBatch``
holds the fields of the JAX package's ``VMInstance`` with a leading instance
axis. ``key_hash`` and ``rng`` are uint32 there; here they are int64 tensors
holding the uint32 value, and every hash is computed in int64 and masked to
32 bits. The host codecs build and read one row as a dict of numpy arrays
with the JAX package's dtypes.

This module imports nothing of the host layers (torch and numpy only) but
the recorder under ``vm/syncs.py``: the port's compiler imports its
``fnv1a_np`` (``compiler/lower.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bytestr as bs
from .syncs import host_sync

# value types
T_EMPTY = 0
T_INT = 1
T_STR = 2
T_LIST = 3

HASH_BASE = 1000003  # polynomial rolling-hash base (mod 2^32)

RUNNING = 0          # the JAX package's vm/config.py status code


class VMBatch(NamedTuple):
    """One row per instance; shapes after the leading N (K slots, L pool
    entries, A arena bytes, O output bytes, ML loop counters, T lanes)."""
    pc: torch.Tensor           # int32
    status: torch.Tensor       # int32 RUNNING/DONE/PARKED/ERROR/OVERFLOW
    park_kind: torch.Tensor    # int32
    park_arg: torch.Tensor     # int32 (pc that parked)
    occ: torch.Tensor          # bool (K)
    key_hash: torch.Tensor     # int64 holding a uint32 (K)
    key_off: torch.Tensor      # int32 (K)
    key_len: torch.Tensor      # int32 (K)
    vtype: torch.Tensor        # int32 (K)
    vint: torch.Tensor         # int32 (K)
    voff: torch.Tensor         # int32 (K)
    vlen: torch.Tensor         # int32 (K)
    pool_type: torch.Tensor    # int32 (L)
    pool_int: torch.Tensor     # int32 (L)
    pool_off: torch.Tensor     # int32 (L)
    pool_len: torch.Tensor     # int32 (L)
    pool_top: torch.Tensor     # int32
    arena: torch.Tensor        # uint8 (A)
    arena_top: torch.Tensor    # int32
    out: torch.Tensor          # uint8 (O)
    out_len: torch.Tensor      # int32
    counters: torch.Tensor     # int32 (ML), 1-based like the for cursor
    rng: torch.Tensor          # int64 holding a uint32
    steps: torch.Tensor        # int32
    last_err: torch.Tensor     # int32
    tpc: torch.Tensor          # int32 (T)
    tstate: torch.Tensor       # int32 (T)
    tpark_kind: torch.Tensor   # int32 (T)
    tpark_arg: torch.Tensor    # int32 (T)
    cur_tid: torch.Tensor      # int32, -1 outside a parallel block
    par_mode: torch.Tensor     # int32
    par_join: torch.Tensor     # int32
    par_epoch: torch.Tensor    # int32

    @property
    def n(self) -> int:
        return self.pc.shape[0]

    def take(self, idx: torch.Tensor) -> "VMBatch":
        """The rows ``idx`` (an int64 index tensor), as a new batch."""
        return VMBatch(*(t.index_select(0, idx) for t in self))

    def to_numpy(self) -> dict:
        """Host copies with the JAX package's dtypes (uint32 hash and rng)."""
        out = {}
        for name, t in self._asdict().items():
            a = t.cpu().numpy()
            out[name] = a.astype(np.uint32) if name in _U32 else a
        return out


_U32 = ("key_hash", "rng")
FIELDS = VMBatch._fields


def _torch_dtype(name: str, a: np.ndarray):
    if name in _U32:
        return torch.int64
    return {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
            }.get(a.dtype, torch.int32)


def from_numpy(fields, device="cpu") -> VMBatch:
    """A batch from per-field arrays with a leading instance axis: a JAX
    ``VMInstance`` batch (``from_numpy(jax_batch._asdict())``) or a dict of
    stacked codec rows."""
    get = fields.get if isinstance(fields, dict) else \
        (lambda k: getattr(fields, k))
    out = []
    for name in FIELDS:
        a = np.asarray(get(name))
        dt = _torch_dtype(name, a)
        a = a.astype(np.int64) if dt == torch.int64 else a
        out.append(torch.from_numpy(np.array(a, copy=True)).to(
            device=device, dtype=dt))
    return VMBatch(*out)


from_jax = from_numpy


def stack_rows(rows: list, device="cpu") -> VMBatch:
    """A batch from codec rows (dicts of numpy arrays)."""
    return from_numpy({k: np.stack([r[k] for r in rows]) for k in FIELDS},
                      device)


def broadcast_row(row: dict, n: int, device="cpu") -> VMBatch:
    """n copies of one codec row, made on the device."""
    one = from_numpy({k: np.asarray(row[k])[None] for k in FIELDS}, device)
    return VMBatch(*(t.expand((n,) + t.shape[1:]).contiguous()
                     for t in one))


def row_of(host: dict, j: int) -> dict:
    """Row j of a dict of host arrays."""
    return {k: host[k][j] for k in FIELDS}


# ---------------------------------------------------------------------------
# device-side store operations (batched over rows)
# ---------------------------------------------------------------------------

def fnv1a(buf: torch.Tensor, length) -> torch.Tensor:
    """Key hash h = sum (b[i]+1) * B^i (mod 2^32) over the first ``length``
    bytes, as int64. Matches ``fnv1a_np``."""
    n = buf.shape[1]
    dev = buf.device
    powers = host_sync(torch.Tensor.to, torch.from_numpy(
        _hash_powers(n).astype(np.int64)), dev)
    length = bs.col(length, buf.shape[0], dev)
    terms = (buf.to(torch.int64) + 1) * powers[None, :]
    live = bs.positions(n, dev)[None, :] < length[:, None]
    return torch.where(live, terms, 0).sum(dim=1) & bs.M32


def _hash_powers(n: int) -> np.ndarray:
    powers = np.empty((n,), np.uint32)
    p = 1
    for i in range(n):
        powers[i] = p
        p = (p * HASH_BASE) & 0xFFFFFFFF
    return powers


def fnv1a_np(data: bytes) -> np.uint32:
    h = 0
    p = 1
    for b in data:
        h = (h + (b + 1) * p) & 0xFFFFFFFF
        p = (p * HASH_BASE) & 0xFFFFFFFF
    return np.uint32(h)


def masked_slot_update(arr: torch.Tensor, slot, value) -> torch.Tensor:
    """arr with arr[r, slot[r]] = value[r] (no write where slot is out of
    range, e.g. -1)."""
    n, k = arr.shape
    slot = bs.col(slot, n, arr.device)
    hit = bs.positions(k, arr.device)[None, :] == slot[:, None]
    if isinstance(value, torch.Tensor):
        value = value.to(arr.dtype)[:, None]
    else:
        value = host_sync(torch.tensor, value, dtype=arr.dtype,
                          device=arr.device)
    return torch.where(hit, value, arr)


def gather_slot(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """arr[r, slot[r]] for an in-range slot per row."""
    return torch.gather(arr, 1, slot.long()[:, None])[:, 0]


def arena_write(st: VMBatch, buf, length, cfg):
    """Append bytes to the arena; returns (st', off, overflow). A logical
    length beyond the payload's width is an overflow (host rescue), never a
    truncation."""
    off = st.arena_top
    length = bs.col(length, st.n, off.device)
    overflow = (off + length > cfg.arena_size) | (length > buf.shape[1])
    safe_off = off.clamp(0, cfg.arena_size - 1)
    arena = bs.write_span(st.arena, safe_off, buf, length, ~overflow)
    st = st._replace(arena=arena,
                     arena_top=torch.where(overflow, st.arena_top,
                                           off + length))
    return st, torch.where(overflow, -1, safe_off).to(torch.int32), overflow


def arena_read(st: VMBatch, off, length, size: int):
    chunk = bs.window(st.arena, off, size)
    length = bs.col(length, st.n, st.arena.device)
    return bs.normalize(chunk, length), length


def find_slot(st: VMBatch, key_buf, key_len):
    """(found, slot, collide) per row. hash+len only prefilters; the first
    candidate's stored key bytes are compared with the probe, and a second
    candidate with other bytes is a collision the caller parks on. ``slot``
    is 0 where no candidate exists (argmax of all-False); callers mask."""
    key_len = bs.col(key_len, st.n, key_buf.device)
    h = fnv1a(key_buf, key_len)
    cand = st.occ & (st.key_hash == h[:, None]) \
        & (st.key_len == key_len[:, None])
    n_cand = cand.sum(dim=1)
    k = cand.shape[1]
    slot = torch.where(cand, bs.positions(k, cand.device)[None, :],
                       k).amin(dim=1)
    slot = torch.where(n_cand > 0, slot, 0).to(torch.int32)
    a = st.arena.shape[1]
    kb = min(key_buf.shape[1], a)
    off = gather_slot(st.key_off, slot).clamp(0, a - 1)
    padded = torch.nn.functional.pad(st.arena, (0, kb))
    stored = bs.window(padded, off, kb)
    stored = bs.normalize(stored, gather_slot(st.key_len, slot))
    probe = bs.normalize(key_buf[:, :kb], key_len)
    bytes_eq = (stored == probe).all(dim=1)
    found = (n_cand > 0) & bytes_eq
    collide = (n_cand > 1) & ~bytes_eq
    return found, slot, collide


def store_set(st: VMBatch, key_buf, key_len, vtype, vint, voff, vlen, cfg):
    """Insert or overwrite a key with a value descriptor; returns (st',
    overflow). Key bytes go to the arena only for a new key; an ambiguous
    (colliding) lookup never writes and reports an overflow."""
    key_len = bs.col(key_len, st.n, key_buf.device)
    found, slot, collide = find_slot(st, key_buf, key_len)
    free = ~st.occ
    have_free = free.any(dim=1)
    k = free.shape[1]
    new_slot = torch.where(free, bs.positions(k, free.device)[None, :],
                           k).amin(dim=1)
    new_slot = torch.where(have_free, new_slot, 0).to(torch.int32)
    st2, key_off, arena_ov = arena_write(st, key_buf, key_len, cfg)
    overflow = torch.where(found, collide, ~have_free | arena_ov | collide)
    use_slot = torch.where(found, slot, new_slot)
    st = st._replace(
        arena=torch.where(found[:, None], st.arena, st2.arena),
        arena_top=torch.where(found, st.arena_top, st2.arena_top))
    h = fnv1a(key_buf, key_len)
    msu = masked_slot_update
    return st._replace(
        occ=msu(st.occ, use_slot, True),
        key_hash=msu(st.key_hash, use_slot, h),
        key_off=msu(st.key_off, use_slot,
                    torch.where(found, gather_slot(st.key_off, use_slot),
                                key_off)),
        key_len=msu(st.key_len, use_slot, key_len),
        vtype=msu(st.vtype, use_slot, bs.col(vtype, st.n, h.device)),
        vint=msu(st.vint, use_slot, bs.col(vint, st.n, h.device)),
        voff=msu(st.voff, use_slot, bs.col(voff, st.n, h.device)),
        vlen=msu(st.vlen, use_slot, bs.col(vlen, st.n, h.device)),
    ), overflow


def store_delete(st: VMBatch, slot) -> VMBatch:
    return st._replace(occ=masked_slot_update(st.occ, slot, False))


# ---------------------------------------------------------------------------
# host codecs: one row as a dict of numpy arrays
# ---------------------------------------------------------------------------

class HostCodecError(ValueError):
    pass


def fresh_row(cfg, seed: int = 0) -> dict:
    K, L, T = cfg.n_slots, cfg.pool_size, cfg.max_threads
    i32 = np.int32
    return {
        "pc": i32(0), "status": i32(RUNNING), "park_kind": i32(0),
        "park_arg": i32(0),
        "occ": np.zeros((K,), np.bool_), "key_hash": np.zeros((K,), np.uint32),
        "key_off": np.zeros((K,), i32), "key_len": np.zeros((K,), i32),
        "vtype": np.zeros((K,), i32), "vint": np.zeros((K,), i32),
        "voff": np.zeros((K,), i32), "vlen": np.zeros((K,), i32),
        "pool_type": np.zeros((L,), i32), "pool_int": np.zeros((L,), i32),
        "pool_off": np.zeros((L,), i32), "pool_len": np.zeros((L,), i32),
        "pool_top": i32(0),
        "arena": np.zeros((cfg.arena_size,), np.uint8), "arena_top": i32(0),
        "out": np.zeros((cfg.out_size,), np.uint8), "out_len": i32(0),
        "counters": np.zeros((cfg.max_loops,), i32),
        "rng": np.uint32(seed), "steps": i32(0), "last_err": i32(0),
        "tpc": np.zeros((T,), i32), "tstate": np.zeros((T,), i32),
        "tpark_kind": np.zeros((T,), i32), "tpark_arg": np.zeros((T,), i32),
        "cur_tid": i32(-1), "par_mode": i32(0), "par_join": i32(0),
        "par_epoch": i32(0),
    }


def encode_inserts(inserts: dict, cfg, seed: int = 0) -> dict:
    """A fresh row whose store holds ``inserts``."""
    st = fresh_row(cfg, seed)
    arena = st["arena"]
    top = 0

    def put_bytes(data: bytes) -> tuple:
        nonlocal top
        if top + len(data) > cfg.arena_size:
            raise HostCodecError("arena overflow while encoding inserts")
        arena[top:top + len(data)] = np.frombuffer(data, np.uint8)
        off = top
        top += len(data)
        return off, len(data)

    pool_top = 0
    slot = 0
    for key, value in inserts.items():
        if slot >= cfg.n_slots:
            raise HostCodecError("too many inserts for slot table")
        kdata = str(key).encode("utf-8")
        if len(kdata) > cfg.max_key:
            raise HostCodecError(f"key too long: {key!r}")
        koff, klen = put_bytes(kdata)
        if isinstance(value, bool):
            raise HostCodecError("bool insert values unsupported on device")
        if isinstance(value, int):
            vt, vi, vo, vl = T_INT, value, 0, 0
        elif isinstance(value, str):
            vo, vl = put_bytes(value.encode("utf-8"))
            vt, vi = T_STR, 0
        elif isinstance(value, list):
            base = pool_top
            for elem in value:
                if pool_top >= cfg.pool_size:
                    raise HostCodecError("list pool overflow")
                if isinstance(elem, bool):
                    raise HostCodecError("bool list elements unsupported")
                if isinstance(elem, int):
                    st["pool_type"][pool_top] = T_INT
                    st["pool_int"][pool_top] = elem
                elif isinstance(elem, str):
                    eo, el = put_bytes(elem.encode("utf-8"))
                    st["pool_type"][pool_top] = T_STR
                    st["pool_off"][pool_top] = eo
                    st["pool_len"][pool_top] = el
                else:
                    raise HostCodecError(
                        f"unsupported list element type: {type(elem)}")
                pool_top += 1
            vt, vi, vo, vl = T_LIST, 0, base, len(value)
        else:
            raise HostCodecError(f"unsupported insert type: {type(value)}")
        st["occ"][slot] = True
        st["key_hash"][slot] = fnv1a_np(kdata)
        st["key_off"][slot] = koff
        st["key_len"][slot] = klen
        st["vtype"][slot] = vt
        st["vint"][slot] = vi
        st["voff"][slot] = vo
        st["vlen"][slot] = vl
        slot += 1
    st["arena_top"] = np.int32(top)
    st["pool_top"] = np.int32(pool_top)
    return st


def encode_instance(inserts: dict, cfg, *, output: str = "", pc: int = 0,
                    counters=None, rng: int = 0, steps: int = 0) -> dict:
    """A full row: inserts, output buffer and control state."""
    st = encode_inserts(inserts, cfg, seed=rng)
    out_data = output.encode("utf-8")
    if len(out_data) > cfg.out_size:
        raise HostCodecError("output buffer overflow while encoding")
    st["out"][:len(out_data)] = np.frombuffer(out_data, np.uint8)
    if counters is not None:
        st["counters"][:len(counters)] = counters
    st.update(pc=np.int32(pc), out_len=np.int32(len(out_data)),
              rng=np.uint32(rng), steps=np.int32(steps))
    return st


def decode_inserts(st) -> dict:
    """A row's insert store as a Python dict (host side)."""
    arena = np.asarray(st["arena"])
    occ = np.asarray(st["occ"])
    out = {}
    for slot in range(occ.shape[0]):
        if not occ[slot]:
            continue
        ko, kl = int(st["key_off"][slot]), int(st["key_len"][slot])
        key = bytes(arena[ko:ko + kl]).decode("utf-8", "replace")
        vt = int(st["vtype"][slot])
        if vt == T_INT:
            out[key] = int(st["vint"][slot])
        elif vt == T_STR:
            vo, vl = int(st["voff"][slot]), int(st["vlen"][slot])
            out[key] = bytes(arena[vo:vo + vl]).decode("utf-8", "replace")
        elif vt == T_LIST:
            base, n = int(st["voff"][slot]), int(st["vlen"][slot])
            elems = []
            for i in range(base, base + n):
                if int(st["pool_type"][i]) == T_INT:
                    elems.append(int(st["pool_int"][i]))
                else:
                    eo, el = int(st["pool_off"][i]), int(st["pool_len"][i])
                    elems.append(bytes(arena[eo:eo + el]).decode(
                        "utf-8", "replace"))
            out[key] = elems
    return out


def decode_output(st) -> str:
    return bytes(np.asarray(st["out"])[:int(st["out_len"])]).decode(
        "utf-8", "replace")
