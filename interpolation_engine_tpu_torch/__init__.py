"""interpolation_engine_tpu_torch — the batched program VM on PyTorch and CUDA.

A port of ``interpolation_engine_tpu``'s device path to an NVIDIA Hopper
card. The JAX package stays the reference: this package reuses its host
layers (JSON5, program loading and validation, the compiler and turbo
planner, the exact host executor, IO and the parallel-lane ring) through
``_shared`` and re-implements only what touched JAX:

* ``vm/turbo.py`` — the turbo engine: slot layout, host codecs, the exact
  host ring and results;
* ``vm/turbo_tables.py`` — a turbo plan flattened into int32 tables that
  one compiled kernel reads;
* ``ops/turbo_step.py`` and ``csrc/turbo_step.cu`` — the step kernel,
  written by hand in CUDA C++, beside its plain PyTorch version;
* ``vm/bytestr.py``, ``vm/state.py``, ``ops/interp_kernel.py``,
  ``ops/match_kernel.py`` and ``vm/step.py`` — the general engine: byte
  strings, the per-instance store and its codecs, interpolation, wildcard
  matching and the batched step, one handler per distinct pc;
* ``ops/brace_scan.py`` and ``csrc/brace_scan.cu`` — the interpolation
  loop's brace scan, written by hand in CUDA C++, beside its plain PyTorch
  version;
* ``vm/driver.py`` and ``cli.py`` — the general engine's ``DeviceRunner``
  with its exact host ring, and the ``--engine device`` entry point.

Every program the turbo planner accepts runs on the turbo engine, lists
and parallel thread lanes included; a value that outgrows its slot raises
``NotPorted`` (promotion to a wider sibling batch is not ported yet). A
program the planner rejects (``NotTurbo``) runs on the general engine,
which has 19 of the 30 opcodes; one holding another opcode raises
``NotPorted`` naming it.
"""

__version__ = "0.1.0"
