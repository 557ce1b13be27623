"""The PyTorch port's one door to the JAX package's host layers
(``interpolation_engine_tpu_torch/_shared.py``): it runs where jax is not
installed, and the port's numpy ``vm/state.py`` matches the JAX package's."""

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
    import importlib.abc, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ModuleNotFoundError(f"No module named {name!r}",
                                          name=name.split(".")[0])
            return None

    for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
        del sys.modules[m]
    sys.meta_path.insert(0, NoJax())
    sys.path.insert(0, sys.argv[1])

    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader)
    from interpolation_engine_tpu_torch.vm.turbo import (
        DONE, TurboConfig, TurboEngine)
    for src in sys.argv[2:]:
        program = json5.loads(loader.add_line_numbers(src))
        engine = TurboEngine(compile_program(program),
                             TurboConfig(width=128, out_width=192,
                                         k_steps=64), device="cpu")
        results = engine.results(engine.run(engine.make_batch(2)))
        assert all(r.status == DONE for r in results), results
        print(results[0].output)
    assert not [m for m in sys.modules if m.split(".")[0] == "jax"]
""")


def test_port_runs_with_jax_blocked():
    import bench
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(ROOT), SPINE,
         bench.adventure_program(t_max=12)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    acc = sum(i % 7 for i in range(1, 41))
    assert proc.stdout.split("\n")[:2] == [
        f"done acc={acc}",
        "gen-scene-1-12;fin turn=12 acc=36 hist=['h5.4', 'h0.5', 'h1.6', "
        "'h2.7', 'h3.8', 'h4.9', 'h5.10', 'h0.11', 'h1.12']"]


def test_fnv1a_matches_jax_package():
    rng = np.random.default_rng(0)
    for n in [0, 1, 2, 7, 31, 64, 200]:
        for _ in range(8):
            key = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert port_state.fnv1a_np(key) == jax_state.fnv1a_np(key)
    for name in ("T_EMPTY", "T_INT", "T_STR", "T_LIST"):
        assert getattr(port_state, name) == getattr(jax_state, name)


def test_port_package_never_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    pkg = ROOT / "interpolation_engine_tpu_torch"
    sources = sorted(p for p in pkg.rglob("*.py")
                     if "_build" not in p.relative_to(pkg).parts)
    assert sources
    for path in sources:
        assert not pattern.search(path.read_text()), path
