"""The device engine's CLI entry: the turbo branch of the JAX package's
``vm/driver.py`` ``run_program_on_device`` (:740-801), on a CUDA device.

A ``host_only`` program runs on the exact host engine, as in the JAX
package. Everything else runs on the turbo engine; ``NotTurbo`` and
``NotPorted`` propagate (there is no general engine to fall back to yet).
"""

from __future__ import annotations

import asyncio
import os

import torch

from .._shared import compile_program, context, loader, runtime
from .turbo import TurboConfig, TurboEngine


def run_program_on_device(filepath: str, args: list, io, batch: int = 1,
                          tcfg: TurboConfig = None) -> int:
    """Run ``batch`` instances of the program on the first CUDA device and
    print instance 0's final output, stripped, like the host CLI."""
    context.CTX.program_dir = os.path.dirname(os.path.abspath(filepath))
    program, _state = loader.load(filepath)
    compiled = compile_program(program)
    if compiled.host_only:
        asyncio.run(runtime.async_main(filepath, list(args), io))
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("the device engine needs a CUDA device")
    engine = TurboEngine(compiled, tcfg, io_factory=lambda i: io,
                         device="cuda")
    final = engine.run(engine.make_batch(batch, list(args)))
    print(engine.results(final, batch)[0].output.strip())
    return 0
