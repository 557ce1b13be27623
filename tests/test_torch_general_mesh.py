"""The general engine over a mesh (``parallel/mesh.py`` ``shard_batch``,
``replicate``, ``batched_run_sharded``, and ``DeviceRunner`` on a sharded
batch) on four CPU shards: bit for bit the run on one device, after every
launch and through the ring to DONE, and at DONE the JAX package's
results (``tests/test_multichip.py:48`` and ``:77``). The counterpart of
``__graft_entry__.dryrun_multichip``: one sharded general step at the
bench's VMConfig, bit for bit one device's."""

import sys
import threading

import numpy as np
import pytest
import torch

import bench
import torch_programs as tp
from torch_helpers import GEN_CFG, compile_port, compile_src, port_cfg

from interpolation_engine_tpu.io.manager import IOManager, ScriptedBackend
from interpolation_engine_tpu.vm import driver as jd
from interpolation_engine_tpu.vm.config import DONE
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.parallel.mesh import (
    ShardedVMBatch, batched_run_sharded, make_mesh, replicate, shard_batch,
    unshard)
from interpolation_engine_tpu_torch.vm import driver as pd
from interpolation_engine_tpu_torch.vm import state as vs
from interpolation_engine_tpu_torch.vm.syncs import host_sync
from interpolation_engine_tpu_torch.ops import brace_scan as scan_mod
from interpolation_engine_tpu_torch.vm.isa import OP_PAR_BEGIN
from interpolation_engine_tpu_torch.vm.step import (GeneralStep,
                                                     pack_tables,
                                                     used_opcodes)

MESH4 = ["cpu"] * 4
PCFG = port_cfg(GEN_CFG)


def same(a, b) -> None:
    for name, x, y in zip(vs.FIELDS, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def runner(src, answers=None):
    """The port's general engine on the CPU; ``answers(i)`` scripts
    instance i's user_inputs."""
    io = port.io_manager
    return pd.DeviceRunner(
        compile_port(src), PCFG, device="cpu",
        io_factory=None if answers is None else
        (lambda i: io.IOManager(io.ScriptedBackend(answers(i)))))


def mesh_answers(i):
    return [f"u{i}", f"v{i}"]


def wait_answers(i):
    return [f"x{i}", f"y{i}"]


# ---- the split ---------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 18, 4])
def test_shard_batch_splits_every_field_contiguously(n):
    r = runner(tp.MESH_SRC)
    batch = r.make_instances(n)
    sharded = shard_batch(batch, MESH4)
    assert isinstance(sharded, ShardedVMBatch) and sharded.n == n
    sizes = [len(p) for p in torch.tensor_split(torch.arange(n), 4)]
    assert list(np.diff(sharded.offsets)) == sizes
    for shard, off in sharded.parts():
        for t, whole in zip(shard, batch):
            assert t.is_contiguous()
            assert t.untyped_storage().data_ptr() != \
                whole.untyped_storage().data_ptr()
            assert torch.equal(t, whole[off:off + shard.n])
    # every instance keeps its random_choice seed: its global row + 1
    assert torch.equal(torch.cat([s.rng for s in sharded.shards]),
                       torch.arange(1, n + 1))
    same(unshard(sharded), batch)
    with pytest.raises(ValueError, match="cannot fill"):
        shard_batch(r.make_instances(3), MESH4)


def test_replicate_puts_one_step_on_each_distinct_device():
    compiled = compile_port(tp.MESH_SRC)
    rep = replicate(compiled, PCFG, MESH4)
    assert list(rep) == [torch.device("cpu")]
    step = rep[torch.device("cpu")]
    assert isinstance(step, GeneralStep) and step.device.type == "cpu"
    for name, arr in pack_tables(compiled).items():
        have = {"code": step.code, "aux": step.aux, "strtab": step.strtab_np,
                "labels": step.labels_np}[name]
        assert np.array_equal(have, arr), name
    assert step.has_threads == (OP_PAR_BEGIN in used_opcodes(compiled))


# ---- the sharded step -----------------------------------------------------------------

STEP_PROGRAMS = {
    "adventure": bench.adventure_program(), "general_ops": tp.GENERAL_OPS,
    "wait": tp.WAIT_SRC, "mesh": tp.MESH_SRC}


@pytest.mark.parametrize("name", sorted(STEP_PROGRAMS))
def test_sharded_steps_equal_one_device(name):
    """At the bench's general VMConfig, 18 instances over four shards
    (split 5, 5, 4, 4): every field bit for bit one device's after each of
    three launches of 8 steps (``dryrun_multichip``'s check)."""
    r = runner(STEP_PROGRAMS[name])
    one = r.make_instances(18)
    many = shard_batch(one, MESH4)
    for _ in range(3):
        one = r.launch(one, 8)
        many = r.launch(many, 8)
        assert isinstance(many, ShardedVMBatch)
        same(unshard(many), one)
    assert int((one.steps > 0).sum()) == 18


def test_batched_run_sharded_keeps_its_input_and_its_mesh():
    compiled = compile_port(tp.MESH_SRC)
    run = batched_run_sharded(MESH4)
    steps = replicate(compiled, PCFG, MESH4)
    batch = shard_batch(runner(tp.MESH_SRC).make_instances(8), MESH4)
    before = [t.clone() for t in unshard(batch)]
    out = run(batch, steps, 4)
    same(unshard(batch), vs.VMBatch(*before))
    assert out.offsets == batch.offsets
    assert not torch.equal(unshard(out).pc, unshard(batch).pc)
    stray = ShardedVMBatch((batch.shards[0]._replace(
        pc=batch.shards[0].pc.to("meta")),) + batch.shards[1:],
        batch.offsets)
    with pytest.raises(ValueError, match="not on the mesh"):
        run(stray, steps, 1)
    assert make_mesh(devices=MESH4) == (torch.device("cpu"),) * 4


def on_8_threads(call) -> dict:
    """``call()`` 500 times on each of 8 threads inside one recording,
    the threads switched every microsecond so that an unlocked count would
    lose updates; returns its counters."""
    def work():
        for _ in range(500):
            call()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with EVENTS.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return rec.counters


def test_scan_launches_count_exactly_from_worker_threads():
    """The shards of a mesh call the brace scan from a worker thread per
    device: every call is counted (on the CPU, the plain version's)."""
    bufs = torch.zeros((2, 8), dtype=torch.uint8)
    lengths = torch.zeros((2,), dtype=torch.int32)
    counters = on_8_threads(lambda: scan_mod.brace_scan(bufs, lengths))
    assert counters == {"plain.brace_scan": 8 * 500}


def test_host_syncs_count_exactly_from_worker_threads():
    """The shards' handlers wait on their devices through ``host_sync``
    from a worker thread each: every wait is counted, and timed."""
    lengths = torch.zeros((2,), dtype=torch.int32)
    counters = on_8_threads(lambda: host_sync(lengths.tolist))
    assert counters == {"general.host_syncs": 8 * 500}


# ---- the sharded ring ----------------------------------------------------------------

def _jax_eager(src, answers, n):
    jr = jd.DeviceRunner(compile_src(src), GEN_CFG, mode="eager",
                         io_factory=lambda i: IOManager(
                             ScriptedBackend(answers(i))))
    final = jr.run(jr.make_instances(n), inner_steps=8, max_rounds=200)
    return jr.results(final)


@pytest.mark.parametrize("name,src,answers,want", [
    ("mesh", tp.MESH_SRC, mesh_answers, "hi;[u{i}!](v{i})"),
    ("wait", tp.WAIT_SRC, wait_answers, "a;t0;x=x{i};t1;y=y{i};z")],
    ids=["mesh", "wait"])
def test_sharded_ring_run_equals_unsharded_and_jax(name, src, answers, want,
                                                   capsys):
    """tests/test_multichip.py:48 and :77 on the port: 64 instances over
    four shards through the ring, each answering its own inputs (the ring
    and the LaneRing keyed by global row), equal field for field to the
    unsharded run, every output the JAX package's, and the first
    instances equal to JAX's eager run."""
    r = runner(src, answers)
    final = r.run(shard_batch(r.make_instances(64), MESH4), inner_steps=8,
                  max_rounds=200)
    ref = runner(src, answers)
    ref_final = ref.run(ref.make_instances(64), inner_steps=8,
                        max_rounds=200)
    same(unshard(final), ref_final)
    res = r.results(final)
    assert r.ring_stats["parks"] == ref.ring_stats["parks"] > 0
    for i, x in enumerate(res):
        assert (x.status, x.output) == (DONE, want.format(i=i))
    for x, j in zip(res, _jax_eager(src, answers, 4)):
        assert (x.status, x.output, x.inserts, x.steps) == (
            j.status, j.output, j.inserts, j.steps)
    capsys.readouterr()


def test_random_choice_draws_the_same_under_sharding(capsys):
    """GENERAL_OPS to DONE over four shards: each instance draws as on one
    device (the JAX LCG from rng = global row + 1)."""
    r = runner(tp.GENERAL_OPS)
    final = r.run(shard_batch(r.make_instances(24), MESH4), inner_steps=8)
    ref = runner(tp.GENERAL_OPS)
    ref_final = ref.run(ref.make_instances(24), inner_steps=8)
    same(unshard(final), ref_final)
    res = r.results(final)
    picks = {tp.general_ops_choice(i + 1) for i in range(24)}
    assert len(picks) > 1
    assert len({x.output for x in res}) == len(picks)
    assert all(x.status == DONE for x in res)
    capsys.readouterr()


def test_export_from_a_sharded_batch_equals_one_device():
    r = runner(tp.NESTED_SRC)
    one = r.make_instances(8)
    for _ in range(4):
        one = r.launch(one, 8)
    many = shard_batch(one, MESH4)
    for i in range(8):
        assert r.export_state(many, i) == r.export_state(one, i)
