"""The harness on the CPU: discovery by file, the metric arithmetic, the
frozen copies, the result line and the import rule."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import metrics, run
from portbench.programs import adventure
from portbench.reference import Machine

HERE = Path(run.__file__).resolve().parent
ROOT = HERE.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def compile_text(text):
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader, validator)
    program = json5.loads(loader.add_line_numbers(text))
    validator.validate_program(program)
    return compile_program(program)


# ---- discovery -------------------------------------------------------------

def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A throwaway cell, configuration, traffic mix and per-layer metric,
    each a new file beside copies of the benchmark's, run with no file of
    the harness edited."""
    for kind in ("configs", "traffic", "metrics"):
        (tmp_path / kind).mkdir()
        for f in (HERE / kind).glob("*.json"):
            (tmp_path / kind / f.name).write_text(f.read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads(
        (HERE / "configs" / "rollout-spine.turbo.json").read_text())
    config["turbo_config"]["k_steps"] = 8
    config.update(warm_steps=8, trace_rounds=2, lag_rounds=1)
    (tmp_path / "configs" / "tiny.turbo.json").write_text(
        json.dumps(config))
    traffic = json.loads(
        (HERE / "traffic" / "resumed-rollout.json").read_text())
    traffic["params"]["n_rooms"] = 3
    traffic["strata"]["room"] = [0, 1, 2]
    (tmp_path / "traffic" / "three-rooms.json").write_text(
        json.dumps(traffic))
    (tmp_path / "metrics" / "setup.again_s.json").write_text(json.dumps(
        {"kind": "span", "span": "setup.engine"}))
    bench["workloads"].append({"name": "tiny", "config": "tiny.turbo",
                               "traffic": "three-rooms", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"][:2]:     # tasks_per_s, round_p95_ms
        m["workloads"].append("tiny")
    bench["per_layer"].append({"name": "setup.again_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "entry", "moves": "setup_s",
                               "workloads": ["tiny"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))

    cell = run.load_cell("tiny", path, tmp_path)
    assert cell["config"]["turbo_config"]["k_steps"] == 8
    assert cell["traffic"]["params"]["n_rooms"] == 3
    assert "setup.again_s" in [m["name"] for m in cell["per_layer"]]
    line = run.run_cell("tiny", 7, 0.2, True, device="cpu", instances=4,
                        bench=path, data=tmp_path)
    assert line["correct"], line["checks"]
    assert line["metrics"]["setup.again_s"]["value"] > 0
    line = run.run_cell("tiny", 7, 0.2, False, device="cpu", instances=4,
                        bench=path, data=tmp_path)
    assert line["correct"] and set(line["metrics"]) == {
        "tasks_per_s", "round_p95_ms", "setup_s"}


def test_every_named_file_exists():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        spec = run.load_cell(cell["name"])
        assert spec["config"]["engine"] in run.ENGINES
        assert {m["reading"] for m in spec["end_to_end"]} >= {
            "tasks_per_s", "setup_s"}
        for m in spec["per_layer"]:
            assert m["kind"] in metrics.KINDS
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()


# ---- arithmetic ------------------------------------------------------------

def test_rate_is_all_the_work_over_all_the_time():
    assert metrics.rate(1_000, 4.0) == 250.0
    with pytest.raises(ValueError):
        metrics.rate(1, 0.0)


def test_p95_over_every_round_sees_a_stall():
    steady = [1.0] * 95
    assert metrics.p95(steady + [50.0] * 5) == 1.0
    assert metrics.p95(steady + [50.0] * 6) == 50.0
    # one stall in 20 rounds is the 95th percentile's own round
    assert metrics.p95([1.0] * 19 + [50.0]) == 1.0
    assert metrics.p95([1.0] * 18 + [50.0] * 2) == 50.0


def trace(device, window=(0.0, 100.0), spans=(), host=(), rounds=4,
          round_steps=1):
    events = [(n, True, s, e) for n, s, e in device]
    events += [(n, False, s, e) for n, s, e in (*spans, *host)]
    return metrics.read_profile(events, window, rounds, round_steps)


def test_idle_share_is_a_union_of_intervals():
    t = trace([("k1", 10, 30), ("k2", 20, 40), ("k3", 60, 70),
               ("Memcpy DtoH", 65, 80), ("early", -10, 5)])
    # busy: [0, 5] (clipped), [10, 40], [60, 80] = 55 of 100
    assert metrics.busy_us(t) == 55.0
    assert metrics.idle_share({}, t, {}) == pytest.approx(45.0)
    assert metrics.gaps(t) == [(5.0, 10.0), (40.0, 60.0), (80.0, 100.0)]
    assert metrics.kernels_per_step({}, t, {}) == 4 / 4   # not the copy


def test_breakdown_names_gaps_by_what_the_host_did():
    t = trace([("k", 10, 40), ("k", 60, 90)],
              spans=[("portbench.launch", 38, 62)],
              host=[("aten::item", 45, 55), ("outer", 0, 100)])
    b = metrics.breakdown(t)
    assert b["device_ops"] == [["k", 60e-6]]
    assert b["idle_gaps"][0] == ["launch / aten::item", 20e-6]
    assert len(b["idle_gaps"]) == 3


def test_the_windows_p95_as_a_per_layer_metric():
    spec = {"name": "w", "unit": "ms", "kind": "window_p95"}
    got = metrics.per_layer([spec], None, {"rounds_ms": [1.0] * 19 + [9.0]})
    assert got == {"w": {"value": 1.0, "unit": "ms"}}
    assert metrics.per_layer([spec], None, {"rounds_ms": []}) == {}


def test_kernel_share_and_nothing_to_read():
    t = trace([("brace_scan_kernel(Args)", 0, 10), ("other", 10, 50)])
    spec = {"kernels": ["brace_scan_kernel", "math_eval_kernel"]}
    assert metrics.kernel_share(spec, t, {}) == pytest.approx(20.0)
    assert metrics.kernel_share({"kernels": ["absent"]}, t, {}) is None
    assert metrics.kernel_roofline({"kernels": ["absent"]}, t, {}) is None
    got = metrics.per_layer(
        [{"name": "x", "unit": "%", "kind": "kernel_share",
          "kernels": ["absent"]},
         {"name": "y", "unit": "%", "kind": "idle_share"}], t, {})
    assert list(got) == ["y"]


def test_frozen_step_bound_is_chip_smokes():
    """bounds/turbo_step.py against chip_smoke.step_bound on a small
    batch, and the roofline it gives over a made-up kernel time."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from interpolation_engine_tpu_torch.vm.turbo import (TurboConfig,
                                                         TurboEngine)
    from portbench.bounds import turbo_step
    turbo = json.loads(
        (HERE / "configs" / "rollout-spine.turbo.json").read_text())
    eng = TurboEngine(compile_text(adventure.source()),
                      TurboConfig(**turbo["turbo_config"]), device="cpu")
    batch = eng.make_batch(96)
    ctx = {"batch": list(batch), "tables": [eng.tables.flat,
                                            eng.tables.lits],
           "launch_steps": 96 * 32}
    want = chip_smoke.step_bound(eng.tables, batch, 96 * 32)["bound_ms"]
    assert turbo_step.bound_ms(ctx, metrics.peaks()) == pytest.approx(
        want, rel=1e-12)
    t = trace([("turbo_step_kernel(Args)", 0, 2 * want * 1e3)])
    got = metrics.kernel_roofline(
        {"kernels": ["turbo_step_kernel"], "bound": "turbo_step"}, t, ctx)
    assert got == pytest.approx(50.0)


# ---- frozen copies ---------------------------------------------------------

def test_frozen_program_is_the_ports_and_plans_alike():
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch._shared import planner
    assert adventure.source() == bench.adventure_program()
    ours = compile_text(run.program_text(traffic()))
    theirs = bench.compile_src(bench.adventure_program())
    assert ours.n_instr == theirs.n_instr == 100
    for field in ("code", "aux", "labels"):
        assert (getattr(ours, field) == getattr(theirs, field)).all()
    assert planner.plan_turbo(ours).slot_of == \
        planner.plan_turbo(theirs).slot_of


@pytest.mark.parametrize("name,key,cls", [
    ("rollout-spine.turbo", "turbo_config", "TurboConfig"),
    ("rollout-spine.general", "vm_config", "VMConfig")])
def test_configs_are_the_deployments_defaults(name, key, cls):
    """Each configuration writes out every field of the config the
    device CLI deploys (``run_program_on_device``), at its default."""
    import dataclasses
    from interpolation_engine_tpu_torch.vm import config, turbo
    want = dataclasses.asdict(getattr(turbo if cls == "TurboConfig"
                                      else config, cls)())
    got = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert got[key] == want


def traffic() -> dict:
    return json.loads(
        (HERE / "traffic" / "resumed-rollout.json").read_text())


def test_every_seed_deals_the_same_mix_in_another_order():
    import torch
    text = run.program_text(traffic())
    a = run.start_states(traffic(), text, 2**31 + 5)
    b = run.start_states(traffic(), text, 2**32 + 9)
    assert len(a) == len(b) == 540 * 2
    shape = [(s["order_index"], len(s["inserts"]["hist"]),
              *(len(str(s["inserts"][k])) for k in ("turn", "acc")))
             for s in a]
    assert shape == [(s["order_index"], len(s["inserts"]["hist"]),
                      *(len(str(s["inserts"][k])) for k in ("turn", "acc")))
                     for s in b]
    assert a != b
    da, db = (run.deal(torch, 5000, len(a), s) for s in (3, 2**31 + 3))
    ca, cb = (torch.bincount(d, minlength=len(a)) for d in (da, db))
    assert (ca.sort().values == cb.sort().values).all()
    assert ca.max() - ca.min() <= 1
    assert (da != db).any()
    assert (run.deal(torch, 5000, len(a), 3) == da).all()


def test_reference_steps_as_both_engines_do():
    """From start states at each place and in different rooms, with
    histories that trim early and late and one that jumps two rooms on,
    the reference's export after every step of a general rollout equals
    both engines' on the CPU; and rows that resume from different states
    sit at different pcs."""
    import torch
    from interpolation_engine_tpu_torch._shared import vm_config
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    from interpolation_engine_tpu_torch.vm import state as vs
    from interpolation_engine_tpu_torch.vm.turbo import (TurboConfig,
                                                         TurboEngine)
    text = run.program_text(traffic())
    states = run.start_states(traffic(), text, 2**31 + 99)
    # strata are room-major, then task (10), then history length (1-9)
    picks = [states[(r * 10 + at) * 9 + h - 1]
             for r, at, h in [(0, 0, 2), (1, 7, 9), (2, 9, 3), (5, 0, 9),
                              (4, 6, 1), (3, 8, 8), (0, 4, 9), (2, 5, 2)]]
    compiled = compile_text(text)
    turbo = json.loads(
        (HERE / "configs" / "rollout-spine.turbo.json").read_text())
    eng = TurboEngine(compiled, TurboConfig(**dict(
        turbo["turbo_config"], k_steps=1)), device="cpu")
    general = json.loads(
        (HERE / "configs" / "rollout-spine.general.json").read_text())
    runner = DeviceRunner(compiled, vm_config.VMConfig(
        **general["vm_config"]), device="cpu")
    t = eng.load_batch(picks)
    g = vs.stack_rows([runner.load_state(s) for s in picks])
    assert len(set(g.pc.tolist())) == len(picks)
    machines = [Machine(text, state=s) for s in picks]
    step = eng.step_fn(len(picks))
    for k in range(1, general["episode_steps"] + 1):
        t, g = step(t), runner.launch(g, 1)
        for i, m in enumerate(machines):
            want = m.run(1).export()
            assert eng.export_state(t, i) == want, (k, i)
            assert runner.export_state(g, i) == want, (k, i)


def test_twin_rows_catch_a_fault_outside_the_sample():
    import torch
    from portbench.run import General
    text = run.program_text(traffic())
    states = run.start_states(traffic(), text, 11)[:3]
    general = json.loads(
        (HERE / "configs" / "rollout-spine.general.json").read_text())
    eng = General(compile_text(text), general, torch, torch.device("cpu"))
    eng.deal_rows(states, torch.tensor([0, 1, 2, 0, 1, 2]))
    batch = eng._launch(eng.make(6), 3)
    assert int(eng.rows_unlike_twin(batch).sum()) == 0
    batch.out[4, 0] ^= 1
    assert eng.rows_unlike_twin(batch).tolist() == [False] * 4 + [
        True, False]


# ---- the result line and the import rule -----------------------------------

@pytest.mark.parametrize("trace_on", [False, True])
def test_the_last_lines_keys(trace_on):
    line = run.run_cell("general", 5, 0.3, trace_on, device="cpu",
                        instances=4)
    if not trace_on:
        assert set(line["metrics"]) == {"tasks_per_s.general", "setup_s"}
    keys = KEYS[:5] + (["breakdown"] if trace_on else []) + ["checks"]
    assert list(line) == keys
    assert list(line["checks"]) == ["rows_failed", "rows_unlike_twin",
                                    "sample_unlike_reference"]
    assert all(set(c) == {"value", "limit"}
               for c in line["checks"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace_on:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert "general_step.round_p95_ms" in line["metrics"]
    json.dumps(line)


def test_no_card_no_line(capfd):
    code = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "adventure",
         "--seed", "1", "--seconds", "1"], cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True)
    assert code.returncode != 0 and code.stdout == ""
    assert "CUDA card" in code.stderr


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules(["interpolation_engine_tpu_torch.vm",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]
    assert run.forbidden_modules(["interpolation_engine_tpu.vm"]) == [
        "interpolation_engine_tpu"]


SCRIPT = """
import sys
{body}
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def loaded_after(body: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(body=body)], cwd=ROOT,
        capture_output=True, text=True, check=True)
    return ast.literal_eval(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """A whole run (on the CPU, at a small batch) loads nothing of JAX or
    of the JAX package, by top-level name compared whole."""
    names = loaded_after('from portbench import run\n'
                         'run.run_cell("general", 3, 0.2, True, '
                         'device="cpu", instances=4)')
    assert "interpolation_engine_tpu_torch" in names
    assert not set(names) & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after(
        "from portbench import reference\n"
        "from portbench.programs import adventure\n"
        "reference.Machine(adventure.source()).run(500).export()")
    assert not {"interpolation_engine_tpu_torch", "torch",
                *run.FORBIDDEN} & set(names)
    tree = ast.parse((HERE / "reference.py").read_text())
    imported = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names} | {
        n.module.split(".")[0] for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom)}
    assert imported <= {"__future__", "re"}
