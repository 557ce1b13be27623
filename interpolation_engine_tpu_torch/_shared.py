"""The one place that imports the JAX package's host layers.

Those layers use no JAX, but ``compiler/lower.py:39`` imports ``fnv1a_np``
from ``vm/state.py``, which runs ``import jax`` at ``vm/state.py:24``. Where
jax is not installed, the port's numpy-only ``vm/state.py`` stands in for
that module, and the import is retried. Where jax is installed, nothing is
substituted. Every other module of the port imports the host layers from here.
"""

import sys

try:
    import interpolation_engine_tpu.compiler  # noqa: F401
except ModuleNotFoundError as e:
    if e.name != "jax":
        raise
    from .vm import state as _state
    sys.modules["interpolation_engine_tpu.vm.state"] = _state

from interpolation_engine_tpu import cli as host_cli, json5  # noqa: E402,F401
from interpolation_engine_tpu.compiler import compile_program  # noqa: E402,F401
from interpolation_engine_tpu.compiler import turbo as planner  # noqa: E402,F401
from interpolation_engine_tpu.core import context, events, executor, runtime  # noqa: E402,F401
from interpolation_engine_tpu.io import manager as io_manager  # noqa: E402,F401
from interpolation_engine_tpu.programs import loader, validator  # noqa: E402,F401
from interpolation_engine_tpu.core import interp as host_interp  # noqa: E402,F401
from interpolation_engine_tpu.vm import config as vm_config  # noqa: E402,F401
from interpolation_engine_tpu.vm import isa, lanering  # noqa: E402,F401
