"""Kernel A's (``turbo_step_kernel``) least time a launch.

A frozen copy of ``chip_smoke.py:365`` ``step_bound`` with its ``bound``
and ``nbytes`` (``:352-362``): a step launch reads and writes the batch
(regs, sbuf, out, meta) once and reads the step tables (flat, lits) once;
each VM step it executes is at least one operation. The least time is the
bytes over the memory rate or the operations over the peak rate, the
larger.
"""


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(ctx: dict, peaks: dict) -> float:
    """``ctx``: ``batch`` and ``tables`` (tensors), ``launch_steps`` (the
    VM steps of one launch)."""
    by_bytes = (2 * nbytes(ctx["batch"]) + nbytes(ctx["tables"])) \
        / peaks["hbm_bytes_per_s"] * 1e3
    by_ops = ctx["launch_steps"] / peaks["ops_per_s"] * 1e3
    return max(by_bytes, by_ops)
