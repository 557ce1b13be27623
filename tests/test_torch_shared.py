"""The PyTorch port stands alone: it keeps its own copy of the host layers
(re-exported by ``interpolation_engine_tpu_torch/_shared.py``), runs where
neither jax nor the JAX package can be imported, imports neither anywhere
(``chip_smoke.py`` included), and its numpy ``vm/state.py`` hashes as the
JAX package's does."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np

from interpolation_engine_tpu.vm import state as jax_state
from interpolation_engine_tpu_torch.vm import state as port_state

ROOT = pathlib.Path(__file__).resolve().parent.parent

# a spine whose loop ends after 40 iterations: cheap on the CPU's plain
# step, long enough to loop through every instruction kind it plans to
SPINE = """
{
    default_state: {order_index: 1, inserts: {i: 0, acc: 0, word: 'spin'}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'set', item:'state-{i}', output_name:'tag'},
        {cmd:'math', input:'{acc} + {i} % 7', output_name:'acc'},
        {cmd:'goto_map', text:'{word}-{i}', target_maps:[
            {'spin-40': '@end'},
            {'spin-*': '@loop'},
            {'*': '@loop'},
        ]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'done acc={acc}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, os, sys

    BLOCKED = ("jax", "jaxlib", "interpolation_engine_tpu", "bench")

    class Blocked(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"No module named {name!r}",
                                          name=name.split(".")[0])
            return None

    for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
        del sys.modules[m]
    sys.meta_path.insert(0, Blocked())
    sys.path[:0] = [sys.argv[1], os.path.join(sys.argv[1], "tests")]

    import chip_smoke
    assert len(chip_smoke.programs()) == 20
    import interpolation_engine_tpu_torch.bench as port_bench
    assert port_bench._turbo_cfg("race-io").k_steps == 16
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader, planner, vm_config)
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    from interpolation_engine_tpu_torch.vm.turbo import (
        DONE, TurboConfig, TurboEngine)
    for src in sys.argv[2:]:
        compiled = compile_program(json5.loads(loader.add_line_numbers(src)))
        try:
            engine = TurboEngine(compiled, TurboConfig(
                width=128, out_width=192, k_steps=64), device="cpu")
            results = engine.results(engine.run(engine.make_batch(2)))
        except planner.NotTurbo:
            runner = DeviceRunner(compiled, vm_config.VMConfig(),
                                  device="cpu")
            results = runner.results(runner.run(runner.make_instances(2)))
        assert all(r.status == DONE for r in results), results
        print(results[0].output)
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
""")


def test_port_runs_with_jax_blocked():
    """With jax, the JAX package and the root bench.py blocked, chip_smoke.py
    and the port's bench import and build their programs, and the port runs
    a turbo program, the adventure and a program the turbo planner rejects
    to DONE."""
    import bench
    import torch_programs as tp
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(ROOT), SPINE,
         bench.adventure_program(t_max=12), tp.NOT_TURBO["list_then_scalar"]],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    acc = sum(i % 7 for i in range(1, 41))
    assert proc.stdout.split("\n")[:3] == [
        f"done acc={acc}",
        "gen-scene-1-12;fin turn=12 acc=36 hist=['h5.4', 'h0.5', 'h1.6', "
        "'h2.7', 'h3.8', 'h4.9', 'h5.10', 'h0.11', 'h1.12']",
        "x=a then ['l', 'm']"]


def test_fnv1a_matches_jax_package():
    rng = np.random.default_rng(0)
    for n in [0, 1, 2, 7, 31, 64, 200]:
        for _ in range(8):
            key = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert port_state.fnv1a_np(key) == jax_state.fnv1a_np(key)
    for name in ("T_EMPTY", "T_INT", "T_STR", "T_LIST"):
        assert getattr(port_state, name) == getattr(jax_state, name)


def test_port_package_never_imports_jax():
    """No module of the port, and not chip_smoke.py, imports jax, the JAX
    package or the root bench.py, or writes into sys.modules under the JAX
    package's names."""
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax[\s.]|import\s+bench\b"
        r"|import\s+interpolation_engine_tpu\b(?!_torch)"
        r"|from\s+interpolation_engine_tpu\b(?!_torch))"
        r"|sys\.modules\[\s*[\"']interpolation_engine_tpu\b(?!_torch)",
        re.M)
    pkg = ROOT / "interpolation_engine_tpu_torch"
    sources = sorted(p for p in pkg.rglob("*.py")
                     if "_build" not in p.relative_to(pkg).parts)
    assert len(sources) > 40
    for path in sources + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
    for bad in ("import jax", "from interpolation_engine_tpu.vm import x",
                "import interpolation_engine_tpu.cli", "    import bench",
                "sys.modules['interpolation_engine_tpu.vm.state'] = s"):
        assert pattern.search(bad), bad
    assert not pattern.search("from interpolation_engine_tpu_torch import x")
    assert not pattern.search(
        "    from interpolation_engine_tpu_torch import bench")
