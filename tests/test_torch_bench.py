"""The port's bench (``interpolation_engine_tpu_torch/bench.py``) against the
JAX package's root ``bench.py`` on the CPU (``BENCH_DEVICE=cpu``): the
programs and constants, each workload's TurboConfig, the executed steps of
each workload's timed launches, the interpolation probe, the JSON line, and
the runs the port refuses.

The JAX bench's turbo measure functions run here at ``BENCH_TILE=1
BENCH_LEAF=1``: a tile of one instance steps at that instance's own pc, and
a leaf of one retires one instruction a dispatch iteration, as the port's
thread does in a launch. At the JAX bench's own tile and leaf the counts
differ by design (the module docstring of the port's bench; the divergent
and leaf tests below). Its general measure function jits the whole VM
step, a compile of minutes on the CPU, so the general count is held
against JAX's ``DeviceRunner`` in eager mode at the same VMConfig, as
``tests/test_torch_general_*.py`` do."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from torch_helpers import (GEN_CFG, compile_port, compile_src,
                           port_host_from_state)

from interpolation_engine_tpu.io.manager import IOManager, BufferBackend
from interpolation_engine_tpu.vm import driver as jax_driver
from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu_torch import bench as pb
from interpolation_engine_tpu_torch.vm import turbo as port_turbo
from interpolation_engine_tpu_torch.vm.turbo import DONE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
ROUNDS = 2
CFG_FIELDS = ("width", "out_width", "k_steps", "list_cap", "elem_width")
SOURCES = {"spine": bench.BENCH_PROGRAM, "interp": bench.INTERP_PROGRAM,
           "adventure": bench.adventure_program(),
           "ring": bench.RING_PROGRAM}


@pytest.fixture
def bench_env(monkeypatch):
    """A clean bench environment on the CPU: every BENCH_ knob unset."""
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    return monkeypatch


class JaxCanned(BufferBackend):
    sync_io = True

    def user_input_sync(self, prompt, default=""):
        return "cgo"

    async def user_input(self, prompt, default=""):
        return "cgo"


@pytest.mark.parametrize("name", ["TARGET_TASKS_PER_SEC", "BENCH_PROGRAM",
                                  "INTERP_PROGRAM", "INTERP_TASKS_PER_ITER",
                                  "INTERP_BYTES_PER_ITER", "RING_PROGRAM"])
def test_copied_constants_equal_the_jax_bench(name):
    assert getattr(pb, name) == getattr(bench, name)


@pytest.mark.parametrize("name", ["race_io_program", "adventure_program"])
@pytest.mark.parametrize("args", [{}, {"n_rooms": 3, "t_max": 7, "trim": 4},
                                  {"n_rooms": 9, "trim": 10}])
def test_copied_programs_equal_the_jax_bench(name, args):
    assert getattr(pb, name)(**args) == getattr(bench, name)(**args)


@pytest.mark.parametrize("workload", ["adventure", "spine", "divergent",
                                      "interp", "ring", "race-io"])
@pytest.mark.parametrize("env", [
    {}, {"BENCH_INNER_STEPS": "12"},
    {"BENCH_WIDTH": "512", "BENCH_ELEM": "128", "BENCH_OUT": "512",
     "BENCH_LIST_CAP": "6"}], ids=["defaults", "inner", "wide"])
def test_turbo_cfg_equals_the_jax_bench(bench_env, workload, env):
    for key, value in env.items():
        bench_env.setenv(key, value)
    mine, theirs = pb._turbo_cfg(workload), bench._turbo_cfg(workload)
    assert isinstance(mine, port_turbo.TurboConfig)
    for f in CFG_FIELDS:
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.tile == port_turbo.TurboConfig().tile   # the port's own


def jax_turbo_count(workload: str, monkeypatch) -> int:
    """The JAX bench's own measure function at N instances and ROUNDS
    launches, a tile and a leaf of one."""
    for key, value in (("BENCH_WORKLOAD", workload), ("BENCH_TILE", "1"),
                       ("BENCH_LEAF", "1")):
        monkeypatch.setenv(key, value)
    compiled = compile_src(SOURCES[workload])
    if workload == "ring":
        return bench._measure_ring(compiled, N, ROUNDS)[0]
    return bench._measure_turbo(compiled, N, ROUNDS, False, 0)[0]


@pytest.mark.parametrize("workload", ["spine", "interp", "adventure",
                                      "ring"])
def test_turbo_executed_equals_the_jax_bench(bench_env, workload, capsys):
    """The steps of the timed launches (and, on the ring, ring rounds) from
    the same batch equal the JAX bench's."""
    compiled = compile_port(SOURCES[workload])
    if workload == "ring":
        mine = pb._measure_ring(compiled, N, ROUNDS, torch.device("cpu"))
    else:
        mine = pb._measure_turbo(compiled, N, ROUNDS, torch.device("cpu"),
                                 workload)
    with pytest.MonkeyPatch.context() as m:
        theirs = jax_turbo_count(workload, m)
    capsys.readouterr()
    assert mine[0] == theirs > 0
    if workload != "ring":
        k = pb._turbo_cfg(workload).k_steps
        assert mine[0] == N * ROUNDS * k      # no instance ends or parks


def test_general_executed_equals_the_jax_runner(bench_env):
    """The general engine's timed launches: ROUNDS launches of
    BENCH_INNER_STEPS steps from the fresh batch, as JAX's DeviceRunner
    counts them at the bench's VMConfig."""
    src = bench.adventure_program()
    mine = pb._measure_general(compile_port(src), N, ROUNDS,
                               torch.device("cpu"))
    assert GEN_CFG == jax_driver.VMConfig(**pb.GENERAL_CFG)
    runner = jax_driver.DeviceRunner(compile_src(src), GEN_CFG, mode="eager")
    state = batch = runner.make_instances(N)
    for _ in range(ROUNDS):
        state = runner._jitted(state, 8)
    theirs = int(np.asarray(state.steps).sum() - np.asarray(batch.steps).sum())
    assert mine[0] == theirs == N * ROUNDS * 8


def test_jax_leaf_retires_more_than_k_steps_a_launch(capsys):
    """The third accounting note: at the JAX bench's spine leaf of 4 a JAX
    launch retires up to 4 instructions a dispatch iteration, where the
    port's launch runs k_steps VM steps an instance."""
    k = pb._turbo_cfg("spine").k_steps
    jax_eng = jax_turbo.TurboEngine(
        compile_src(bench.BENCH_PROGRAM),
        jax_turbo.TurboConfig(tile=8, width=128, out_width=128, k_steps=k,
                              leaf=4), interpret=True)
    jb = jax_eng.step_fn(8)(jax_eng.make_batch(8))
    eng = port_turbo.TurboEngine(compile_port(bench.BENCH_PROGRAM),
                                 pb._turbo_cfg("spine"), device="cpu")
    b = eng.step_fn(8)(eng.make_batch(8))
    assert pb._steps(b) == 8 * k
    assert int(np.asarray(jb.regs[:, 2]).sum()) == 4 * 8 * k
    capsys.readouterr()


def test_divergent_carries_more_steps_a_launch_and_agrees_at_done(
        tmp_path, capsys):
    """The divergent batch (8 states at spread order indexes) on a t_max-cut
    adventure: after one launch the port has run more steps than the JAX
    kernel, which steps each tile of 8 at its lanes' minimum pc (the
    divergent difference); run to DONE, every instance has the JAX
    engine's step count and the host's output and inserts."""
    src = bench.adventure_program(t_max=6)
    tcfg = pb._turbo_cfg("divergent")
    eng = port_turbo.TurboEngine(compile_port(src), tcfg, device="cpu")
    states = pb.divergent_states(eng.compiled, eng.plan.slot_of, 16, 8)
    jeng = jax_turbo.TurboEngine(
        compile_src(src), jax_turbo.TurboConfig(
            tile=8, leaf=1, **{f: getattr(tcfg, f) for f in CFG_FIELDS}),
        interpret=True)
    assert states == bench_divergent_states(jeng, 16)
    b = eng.step_fn(16)(eng.load_batch(states))
    jb = jeng.step_fn(16)(jeng.load_batch(states))
    mine, theirs = pb._steps(b), int(np.asarray(jb.regs[:, 2]).sum())
    assert mine == 16 * tcfg.k_steps > theirs
    res = eng.results(eng.run(b, max_rounds=50))
    jres = jeng.results(jeng.run(jb, max_rounds=50))
    assert [r.steps for r in res] == [r.steps for r in jres]
    assert len({r.steps for r in res}) > 1
    capsys.readouterr()
    hosts = {}
    for st, r in zip(states, res):
        if st["order_index"] not in hosts:
            hosts[st["order_index"]] = port_host_from_state(src, tmp_path, st)
        host = hosts[st["order_index"]]
        assert (r.status, r.output, r.inserts) == (
            DONE, host["output"], dict(host["inserts"]))
    capsys.readouterr()


def bench_divergent_states(jeng, n: int) -> list:
    """The states the JAX bench's _measure_turbo builds at divergence 8
    (bench.py:517-530), for the JAX engine ``jeng``."""
    compiled = jeng.compiled
    inserts = dict(compiled.program["default_state"]["inserts"])
    extra = {"scene": "s", "gen": "g", "hlen": 1}
    inserts.update({k: v for k, v in extra.items()
                    if k in jeng.plan.slot_of})
    n_top = len(compiled.program["order"])
    targets = [1 + (k * n_top) // 8 for k in range(8)]
    return [{"inserts": dict(inserts), "output": "",
             "order_index": targets[i % 8]} for i in range(n)]


def test_race_io_counts_47_on_both_port_paths_and_jax_fast_44(
        tmp_path, capsys, monkeypatch):
    """race-io at 3 turns on the bench's two pipelined shard engines to
    DONE: the port's fast park path and its exact ring both count 47 steps
    an instance, as the JAX exact ring does; the JAX fast path counts 44
    (the race-io difference). Every instance has the host's output."""
    import asyncio
    src = bench.race_io_program(t_max=3)
    tcfg = pb._turbo_cfg("race-io")
    counts = {}
    for fast in ("1", "0"):
        monkeypatch.setenv("IE_TPU_FAST_RING", fast)
        engines = port_turbo.make_shard_engines(
            compile_port(src), tcfg, 2, device="cpu",
            io_factory=lambda i: pb.io_manager.IOManager(pb._Canned("cgo")))
        port_turbo.assign_shard_ids(engines, 8)
        pairs = [(e, e.make_batch(8)) for e in engines]
        finals = asyncio.run(port_turbo.run_pipelined(pairs, max_rounds=200))
        res = [r for e, f in zip(engines, finals) for r in e.results(f)]
        counts[("port", fast)] = {r.steps for r in res}
        assert sum(e.ring_stats["fast_parks"] for e in engines) == \
            (48 if fast == "1" else 0)
    jcfg = jax_turbo.TurboConfig(tile=8, leaf=1, **{
        f: getattr(tcfg, f) for f in CFG_FIELDS})
    jax_compiled = compile_src(src)
    step_fns = None
    for fast in ("1", "0"):
        monkeypatch.setenv("IE_TPU_FAST_RING", fast)
        jeng = jax_turbo.TurboEngine(jax_compiled, jcfg, interpret=True,
                                     io_factory=lambda i: IOManager(
                                         JaxCanned()))
        if step_fns is not None:
            jeng._step_fns = step_fns      # the same kernel: one compile
        jres = jeng.results(jeng.run(jeng.make_batch(16), max_rounds=200))
        step_fns = jeng._step_fns
        counts[("jax", fast)] = {r.steps for r in jres}
    assert counts == {("port", "1"): {47}, ("port", "0"): {47},
                      ("jax", "1"): {44}, ("jax", "0"): {47}}
    capsys.readouterr()
    host = port_host_from_state(src, tmp_path, {
        "order_index": 1, "output": "",
        "inserts": compile_port(src).program["default_state"]["inserts"]},
        ["cgo"] * 3)
    assert all((r.status, r.output, r.inserts)
               == (DONE, host["output"], dict(host["inserts"]))
               for r in res)
    capsys.readouterr()


def test_interp_probe_renders_the_lengths_of_jax_interpolate():
    """One pass of the interpolation probe renders, row for row, the
    lengths the JAX bench's probe renders on the same batch."""
    import jax
    import jax.numpy as jnp
    from interpolation_engine_tpu.ops import interp_kernel as jik
    from interpolation_engine_tpu.vm.config import VMConfig
    from interpolation_engine_tpu.vm.state import encode_instance
    res = pb.interp_probe(N, "cpu")()
    cfg = VMConfig(**pb.INTERP_CFG)
    assert (pb.INTERP_INSERTS, pb.INTERP_TEMPLATE) == (
        {"who": "traveler", "scene": "the tower of dawn", "turn": 12847},
        "You are {who} at {scene} on turn {turn}; "
        "{who} studies {scene} again.")
    proto = encode_instance(pb.INTERP_INSERTS, cfg, pc=0, rng=1)
    batch = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), proto)
    data = pb.INTERP_TEMPLATE.encode("utf-8")
    tmpl = np.zeros((cfg.max_str,), np.uint8)
    tmpl[:len(data)] = np.frombuffer(data, np.uint8)
    lens = jax.jit(jax.vmap(lambda s: jik.interpolate(
        s, jnp.asarray(tmpl), jnp.int32(len(data)), cfg).length))(batch)
    assert res.length.numpy().tolist() == np.asarray(lens).tolist()
    assert bool((res.err == 0).all()) and int(res.length[0]) == len(
        "You are traveler at the tower of dawn on turn 12847; "
        "traveler studies the tower of dawn again.")


def test_the_json_line_names_the_device_the_engine_and_the_workload(
        bench_env, capsys):
    bench_env.setenv("BENCH_INSTANCES", "64")
    bench_env.setenv("BENCH_ROUNDS", "1")
    bench_env.setenv("BENCH_WORKLOAD", "ring")
    bench_env.setenv("BENCH_ENGINE", "general")
    assert pb.main() == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    # the ring runs the turbo engine whatever BENCH_ENGINE says
    assert line["metric"] == ("batched VM tasks/sec (64 instances, cpu, "
                              "torch turbo engine, ring workload[8 instrs])")
    assert line["unit"] == "tasks/sec" and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench.TARGET_TASKS_PER_SEC, 4)
    assert "# ring: rounds=" in err and "# executed=" in err
    assert "# interpolation_bytes_per_sec_general_kernel=" in err


def test_module_entry_prints_the_line_last(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_DEVICE="cpu", BENCH_INSTANCES="64", BENCH_ROUNDS="1",
               BENCH_WORKLOAD="interp", BENCH_INTERP="0")
    proc = subprocess.run(
        [sys.executable, "-m", "interpolation_engine_tpu_torch.bench"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == ("batched VM tasks/sec (64 instances, cpu, "
                              "torch turbo engine, interp workload[6 instrs])")
    assert "# interpolation_bytes_per_sec_turbo=" in proc.stderr
    assert "general_kernel" not in proc.stderr


def test_no_card_and_no_cpu_asked_fails_with_no_line(bench_env, capsys):
    bench_env.delenv("BENCH_DEVICE")
    bench_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        pb.main()
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("knob", ["BENCH_TILE", "BENCH_LEAF",
                                  "BENCH_COLD_GUARD", "BENCH_COMPILE_BUDGET_S",
                                  "BENCH_FORCE_CPU"])
def test_each_mosaic_knob_is_refused(bench_env, capsys, knob):
    assert knob in pb.REFUSED
    bench_env.setenv(knob, "1")
    with pytest.raises(SystemExit) as e:
        pb.main()
    assert knob in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("env", [{"BENCH_WORKLOAD": "chat"},
                                 {"BENCH_ENGINE": "eager"},
                                 {"BENCH_DEVICE": "mps"}])
def test_unknown_workload_engine_or_device_is_refused(bench_env, capsys,
                                                      env):
    for key, value in env.items():
        bench_env.setenv(key, value)
    with pytest.raises(SystemExit) as e:
        pb.main()
    assert list(env.values())[0] in str(e.value.code)
    assert capsys.readouterr().out == ""
