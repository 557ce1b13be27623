"""interpolation_engine_tpu_torch — the batched program VM on PyTorch and CUDA.

A port of ``interpolation_engine_tpu``'s device path to an NVIDIA Hopper
card. The JAX package stays the reference; this package imports nothing of
it. It keeps its own copy of the host layers, under the same subpackage
paths (``json5/``, ``native/``, ``programs/``, ``tools/prog_parser.py``,
``compiler/``, ``core/``, ``io/``, ``chat/``, ``vm/config.py``,
``vm/isa.py``, ``vm/lanering.py`` and ``cli.py``), re-exported for the
device modules by ``_shared``, and re-implements what touched JAX:

* ``vm/turbo.py`` — the turbo engine: slot layout, host codecs, the exact
  host ring and results, on one device or over a mesh, and sibling shard
  engines pipelined on one event loop;
* ``parallel/mesh.py`` — the data-parallel split of a turbo batch over
  several devices;
* ``vm/turbo_tables.py`` — a turbo plan flattened into int32 tables that
  one compiled kernel reads;
* ``ops/turbo_step.py`` and ``csrc/turbo_step.cu`` — the step kernel,
  written by hand in CUDA C++, beside its plain PyTorch version, and the
  step over a mesh's shards; ``csrc/regroup.cu`` groups a large launch's
  rows by pc first, so that a warp's rows start at one instruction;
* ``vm/bytestr.py``, ``vm/state.py``, ``ops/interp_kernel.py``,
  ``ops/match_kernel.py``, ``ops/math_kernel.py`` and ``vm/step.py`` — the
  general engine: byte strings, the per-instance store and its codecs,
  interpolation, wildcard matching, the byte math evaluator and the
  batched step, one handler per distinct pc;
* ``ops/brace_scan.py`` and ``csrc/brace_scan.cu`` — the interpolation
  loop's brace scan, written by hand in CUDA C++, beside its plain PyTorch
  version;
* ``vm/driver.py`` and ``cli.py`` — the general engine's ``DeviceRunner``
  with its exact host ring, and the ``--engine device`` entry point.

Every program the turbo planner accepts runs on the turbo engine, lists
and parallel thread lanes included; an instance whose value outgrows its
slot moves to a sibling batch 4x wider, and one that outgrows that too
escapes to one batch of the general engine. A program the planner rejects
(``NotTurbo``) runs on the general engine, which has all 30 opcodes.
"""

__version__ = "0.1.0"
