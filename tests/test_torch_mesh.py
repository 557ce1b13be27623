"""The turbo engine over several devices (``parallel/mesh.py``, the sharded
step, the sharded ring and the shard engines) on CPU shards: bit for bit
equal to the engine on one device, and at DONE to the JAX engine and the
host."""

import asyncio

import numpy as np
import pytest
import torch

import bench
from torch_helpers import (compile_port, fast_ring, jax_engine, port_engine,
                           run_host, summary)

from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.parallel.mesh import (
    ShardedTurboBatch, make_mesh, shard_turbo_batch, unshard)
from interpolation_engine_tpu_torch.vm import turbo as pt

MESH4 = ["cpu"] * 4
ADV_TCFG = pt.TurboConfig(tile=2, width=64, out_width=128, k_steps=8)


def same_batch(a, b) -> None:
    for name, x, y in zip(("regs", "sbuf", "out", "meta"), a, b):
        assert torch.equal(x, y), name


def spread(eng, batch, key, hi, seed=0):
    """Each instance starts at its own value of int slot ``key``."""
    col = eng.cols.sint(eng.plan.slot_of[key])
    gen = torch.Generator().manual_seed(seed)
    batch.regs[:, col] = torch.randint(0, hi, (batch.regs.shape[0],),
                                       generator=gen, dtype=torch.int32)


# ---- the mesh and the split --------------------------------------------------------

def test_make_mesh_takes_repeats_and_a_prefix():
    mesh = make_mesh(devices=MESH4)
    assert mesh == (torch.device("cpu"),) * 4
    assert make_mesh(2, devices=MESH4) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh(5, devices=MESH4)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("n", [16, 18, 4])
def test_shards_are_contiguous_tensors_of_their_own(n):
    eng = port_engine(bench.adventure_program(), ADV_TCFG)
    batch = eng.make_batch(n)
    spread(eng, batch, "turn", 600)
    sharded = shard_turbo_batch(batch, make_mesh(devices=MESH4))
    sizes = [len(p) for p in torch.tensor_split(torch.arange(n), 4)]
    assert list(np.diff(sharded.offsets)) == sizes
    assert sharded.offsets[0] == 0 and sharded.n == n
    for shard, off in sharded.parts():
        size = shard.regs.shape[0]
        for t, whole in zip(shard, batch):
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() != \
                whole.untyped_storage().data_ptr()
        assert torch.equal(shard.regs, batch.regs[off:off + size])
        assert torch.equal(shard.sbuf, batch.sbuf[:, off:off + size])
        assert torch.equal(shard.meta, batch.meta[:, off:off + size])
    same_batch(unshard(sharded), batch)
    with pytest.raises(ValueError, match="cannot fill"):
        shard_turbo_batch(eng.make_batch(3), make_mesh(devices=MESH4))


# ---- the sharded step ---------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 18])
def test_sharded_step_equals_the_unsharded_step(n):
    """Over 4 CPU shards, after each of 3 launches, the sharded batch is
    bit-identical to the unsharded one (adventure, instances spread over
    their turn counter so lanes diverge; n=18 splits unevenly)."""
    src = bench.adventure_program()
    one = port_engine(src, ADV_TCFG)
    four = port_engine(src, ADV_TCFG, mesh=MESH4)
    assert four.device == torch.device("cpu") and len(four.mesh) == 4
    ref = one.make_batch(n)
    spread(one, ref, "turn", 600)
    sharded = shard_turbo_batch(ref, four.mesh)
    step1, step4 = one.step_fn(n), four.step_fn(n)
    for _ in range(3):
        step1(ref)
        # CPU shards run the plain version, once a shard, and no kernel
        with EVENTS.recording() as rec:
            assert step4(sharded) is sharded
        assert rec.counters == {"plain.turbo_step": 4}
        same_batch(unshard(sharded), ref)
    assert int((ref.regs[:, pt.C_STATUS] == DONE).sum()) < n


def test_sharded_step_and_its_plain_version_agree():
    eng = port_engine(bench.adventure_program(), ADV_TCFG, mesh=MESH4)
    a = eng.make_batch(16)
    b = ShardedTurboBatch(tuple(type(s)(*(t.clone() for t in s))
                                for s in a.shards), a.offsets)
    tables = eng.step_tables
    ts.sharded_turbo_step(tables, a, 8)
    ts.sharded_turbo_step_reference(tables, b, 8)
    same_batch(unshard(a), unshard(b))


def test_build_sharded_step_fn_builds_tables_once_per_device():
    eng = port_engine(bench.adventure_program(), ADV_TCFG)
    step = pt.build_sharded_step_fn(eng.tables.host, ADV_TCFG, MESH4)
    assert list(step.tables) == [torch.device("cpu")]
    sharded = shard_turbo_batch(eng.make_batch(8), make_mesh(devices=MESH4))
    ref = eng.make_batch(8)
    step(sharded)
    eng.step_fn(8)(ref)
    same_batch(unshard(sharded), ref)


def test_engine_takes_exactly_one_of_device_and_mesh():
    compiled = compile_port(bench.adventure_program())
    with pytest.raises(TypeError, match="exactly one"):
        pt.TurboEngine(compiled, ADV_TCFG)
    with pytest.raises(TypeError, match="exactly one"):
        pt.TurboEngine(compiled, ADV_TCFG, device="cpu", mesh=MESH4)
    one = port_engine(bench.adventure_program(), ADV_TCFG)
    with pytest.raises(ValueError, match="sharded"):
        one.step_fn(8)(shard_turbo_batch(one.make_batch(8),
                                         make_mesh(devices=MESH4)))


def test_engine_shares_step_tables_only_on_its_own_devices():
    """A sibling built with another engine's step_tables uses that very
    copy; tables for other devices are refused."""
    compiled = compile_port(bench.adventure_program())
    four = pt.TurboEngine(compiled, ADV_TCFG, mesh=MESH4)
    sib = pt.TurboEngine(compiled, ADV_TCFG, mesh=MESH4, plan=four.plan,
                         step_tables=four.step_tables)
    assert sib.step_tables is four.step_tables and sib.tables is four.tables
    with pytest.raises(ValueError, match="step_tables"):
        pt.TurboEngine(compiled, ADV_TCFG, device="meta",
                       step_tables=four.step_tables)


# ---- the sharded ring ---------------------------------------------------------------

# tests/test_multichip.py:141-165: a spilled output, a literal and an
# interpolated prompt, and a race with an input lane
RING = """
{
    default_state: {order_index: 1, inserts: {i: 0, who: 'w'}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'print', text:'line {i} of text;'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'4': '@ask'}, {'*': '@loop'}]},
        {cmd:'label', name:'@ask'},
        {cmd:'user_input', prompt:'fast? ', output_name:'a'},
        {cmd:'user_input', prompt:'slow {who}? ', output_name:'b'},
        {cmd:'parallel_race', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'g-{i}', output_name:'gen'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'user_input', prompt:'> ', output_name:'c'},
            ]},
        ]},
        {cmd:'print', text:'a={a} b={b} c={c} gen={gen}'},
    ],
    named_tasks: {}, save_states: {},
}
"""
RING_SIZES = dict(tile=4, width=64, out_width=48, k_steps=16)


def answers(i):
    return [f"A{i}", f"B{i}", f"C{i}"]


def ring_engine(mesh=None):
    io = port.io_manager
    kw = {"mesh": mesh} if mesh else {"device": "cpu"}
    return pt.TurboEngine(compile_port(RING), pt.TurboConfig(**RING_SIZES),
                          io_factory=lambda i: io.IOManager(
                              io.ScriptedBackend(answers(i))), **kw)


def test_sharded_ring_equals_unsharded_jax_and_host(tmp_path, capsys):
    n = 12
    one = ring_engine()
    ref = one.run(one.make_batch(n), max_rounds=300)
    four = ring_engine(MESH4)
    final = four.run(four.make_batch(n), max_rounds=300)
    assert isinstance(final, ShardedTurboBatch)
    same_batch(unshard(final), ref)
    assert four.ring_stats["parks"] == one.ring_stats["parks"] > 2 * n
    res = four.results(final)
    assert [summary(r) for r in res] == [summary(r) for r in
                                         one.results(ref)]
    assert any(len(r.output) > RING_SIZES["out_width"] for r in res)

    jeng = jax_turbo.TurboEngine(
        jax_engine(RING).compiled, jax_turbo.TurboConfig(**RING_SIZES),
        io_factory=lambda i: IOManager(ScriptedBackend(answers(i))),
        interpret=True)
    jres = jeng.results(jeng.run(jeng.make_batch(n), max_rounds=300), n)
    for r, j in zip(res, jres):
        assert (r.output, r.inserts, r.status) == (j.output, j.inserts,
                                                   j.status)
        assert r.status == DONE
    host = run_host(RING, tmp_path, answers(0))
    capsys.readouterr()
    assert (res[0].output, res[0].inserts) == (host["output"],
                                               dict(host["inserts"]))


def test_sharded_ring_maps_ids_through_every_shard():
    """A parked row of every shard is gathered, serviced with its own IO
    and scattered back to its shard."""
    eng = ring_engine(MESH4)
    final = eng.run(eng.make_batch(8), max_rounds=300)
    outs = [r.output for r in eng.results(final)]
    for i, out in enumerate(outs):
        assert f"a=A{i} b=B{i}" in out


ECHO = """{default_state: {order_index: 1, inserts: {s: 'ab'}},
          order: [{cmd:'user_input', prompt:'? ', output_name:'s'},
                  {cmd:'print', text:'{s}'}],
          named_tasks: {}, save_states: {}}"""


def echo_engine(answer):
    """ECHO over MESH4, instance i answering ``answer * (i + 1)``."""
    io = port.io_manager
    return pt.TurboEngine(compile_port(ECHO), pt.TurboConfig(**RING_SIZES),
                          io_factory=lambda i: io.IOManager(
                              io.ScriptedBackend([answer * (i + 1)])),
                          mesh=MESH4)


def test_promotion_still_raises_not_ported_on_a_mesh(tmp_path, capsys):
    """Past the sibling, a mesh engine's instances escape: answers of 300
    bytes and more outgrow the 256-byte sibling of the 64-byte shards and
    finish in one general-engine batch on the mesh's first device, the
    others in the sibling, every instance equal to the host."""
    eng = echo_engine("x" * 100)
    res = eng.results(eng.run(eng.make_batch(8)))
    assert sorted(eng._escape_results) == list(range(8))
    [runner] = eng.escape_runners
    assert runner.instance_ids == list(range(2, 8))
    assert runner.device == torch.device(MESH4[0])
    for i, r in enumerate(res):
        host = run_host(ECHO, tmp_path, ["x" * 100 * (i + 1)])
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


def test_promotion_on_a_mesh_agrees_with_host(tmp_path, capsys):
    """A 75-byte answer and more outgrow the 64-byte slots of every shard,
    and each such instance finishes in the one 256-byte sibling on the
    mesh's first device, equal to the host."""
    eng = echo_engine("x" * 25)
    res = eng.results(eng.run(eng.make_batch(8)))
    assert sorted(eng._escape_results) == [2, 3, 4, 5, 6, 7]   # > 64 bytes
    for i, r in enumerate(res):
        host = run_host(ECHO, tmp_path, ["x" * 25 * (i + 1)])
        capsys.readouterr()
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


# ---- shard engines ------------------------------------------------------------------

RACE_IO = bench.race_io_program(t_max=3)


def test_shard_engines_run_pipelined_equal_one_engine():
    """make_shard_engines(2) + assign_shard_ids + run_pipelined on race-io:
    the final batches, concatenated, equal the single engine's; the ids
    are disjoint and the siblings share one LaneRing and the tables. Every
    park takes the exact path here, so that each goes through the shared
    LaneRing under its global id (the fast path's pipelined run is in
    tests/test_torch_turbo_fastring.py)."""
    n, tcfg = 8, pt.TurboConfig(width=64, out_width=128, k_steps=16)
    io = port.io_manager

    def factory(i):
        return io.IOManager(io.ScriptedBackend(["cgo"] * 3))
    single = pt.TurboEngine(compile_port(RACE_IO), tcfg, io_factory=factory,
                            device="cpu")
    ref = single.run(single.make_batch(n))
    with fast_ring(False):
        engines = pt.make_shard_engines(compile_port(RACE_IO), tcfg, 2,
                                        io_factory=factory, device="cpu")
    pt.assign_shard_ids(engines, n // 2)
    a, b = engines
    assert a._lanering is b._lanering and a.plan is b.plan
    assert a.step_tables is b.step_tables
    assert set(a.instance_ids).isdisjoint(b.instance_ids)
    assert sorted(a.instance_ids + b.instance_ids) == list(range(n))
    seen = []
    service = a._lanering.service

    async def keyed(rt, gid, *args, **kw):
        seen.append(gid)
        return await service(rt, gid, *args, **kw)
    a._lanering.service = keyed
    finals = asyncio.run(pt.run_pipelined(
        [(e, e.make_batch(n // 2)) for e in engines]))
    for f, field in enumerate(("regs", "sbuf", "out", "meta")):
        axis = 1 if field in ("sbuf", "meta") else 0
        assert torch.equal(torch.cat([b[f] for b in finals], dim=axis),
                           ref[f]), field
    assert sorted(set(seen)) == list(range(n))
    res = a.results(finals[0]) + b.results(finals[1])
    assert [summary(r) for r in res] == [summary(r) for r in
                                         single.results(ref)]
    assert all(r.status == DONE and r.steps == 47 for r in res)
    assert a.ring_stats["parks"] + b.ring_stats["parks"] == 3 * n
