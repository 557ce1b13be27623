"""CLI: ``python -m interpolation_engine_tpu_torch.cli [--engine device]
[--batch N] prog.json5 [args...]``.

The flags are the JAX package's (``interpolation_engine_tpu.cli``). With
``--engine device`` the program runs on this package's turbo engine on the
CUDA device; everything else is the JAX package's host CLI, which uses no
JAX. Either way the last line printed is the final output, stripped.
"""

from __future__ import annotations

import os

from ._shared import context, host_cli, io_manager


def main(argv=None) -> int:
    args = host_cli.build_parser().parse_args(argv)
    if args.engine != "device" or args.analyze or not args.program:
        return host_cli.main(argv)
    ctx = context.CTX
    ctx.log_sink = (open(args.log_path, "a") if args.log_path
                    else open(os.devnull, "w"))
    ctx.prompt_history_path = args.prompt_history
    ctx.agent_mode = args.agent_mode
    ctx.agent_output_path = args.agent_output
    ctx.agent_input_path = args.agent_input
    if args.inserts_dir:
        ctx.inserts_dir = args.inserts_dir
    if args.agent_mode:
        backend = io_manager.AgentBackend(args.agent_output, args.agent_input)
    else:
        backend = io_manager.LineTerminalBackend()
    from .vm.driver import run_program_on_device
    return run_program_on_device(args.program, args.program_arguments,
                                 io_manager.IOManager(backend),
                                 batch=args.batch)


if __name__ == "__main__":
    raise SystemExit(main())
