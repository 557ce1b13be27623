"""The brace scan: the CUDA kernel's wrapper and its plain PyTorch version.

``brace_scan(bufs, lengths)`` returns, per row of ``bufs`` (N, MS) uint8
with ``lengths`` (N,) int32, the int32 row ``(n_open, n_close, outer_from,
inner_to)`` that one step of the interpolation loop needs
(``ops/interp_kernel.py``): the visible ``{`` and ``}`` counts in
``[0, length)``, the rightmost visible ``{`` (or -1) and the first visible
``}`` strictly after it (or -1). A brace right after a backslash is hidden.

On CUDA tensors it launches ``csrc/brace_scan.cu`` (built by
``ops/build.py``: one thread a row, a block's rows staged in shared memory,
one pass of word-wide compares) or raises; on CPU tensors, and only there,
it runs ``brace_scan_reference``, which works on any device so that it can
be held against the kernel on the card. The two agree bit for bit. They replace the
TPU kernel ``_scan_kernel`` of ``interpolation_engine_tpu/ops/pallas_scan.py``
in both its per-string and its batched call.

A kernel launch counts as ``kernel.brace_scan`` and a call of the plain
version as ``plain.brace_scan`` in ``EVENTS`` (``core/events.py``).
"""

from __future__ import annotations

import torch

from ..core.events import EVENTS
from ..vm.bytestr import BACKSLASH, BRACE_CLOSE, BRACE_OPEN


def kernel_plan(ms: int) -> dict:
    """The kernel's tile for rows of ``ms`` bytes on the current card: rows
    a block, shared bytes a block, and blocks the card keeps on one SM."""
    import ctypes
    from .build import call
    out = (ctypes.c_int * 3)()
    call("brace_scan_plan", ms, out)
    return {"rows": out[0], "smem": out[1], "blocks_per_sm": out[2]}


def _check(bufs: torch.Tensor, lengths: torch.Tensor) -> None:
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs: want uint8 2-d, got {bufs.dtype} "
                         f"{bufs.dim()}-d")
    if lengths.dtype != torch.int32 or lengths.dim() != 1:
        raise ValueError(f"lengths: want int32 1-d, got {lengths.dtype} "
                         f"{lengths.dim()}-d")
    if lengths.shape[0] != bufs.shape[0]:
        raise ValueError(f"{bufs.shape[0]} rows but {lengths.shape[0]} "
                         f"lengths")
    if lengths.device != bufs.device:
        raise ValueError(f"bufs on {bufs.device}, lengths on "
                         f"{lengths.device}")
    if not (bufs.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("bufs and lengths must be contiguous")


def brace_scan(bufs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32: n_open, n_close, outer_from, inner_to per row."""
    _check(bufs, lengths)
    if bufs.device.type == "cpu":
        return brace_scan_reference(bufs, lengths)
    if bufs.device.type != "cuda":
        raise ValueError(f"no brace scan for device {bufs.device}")
    n, ms = bufs.shape
    out = torch.empty((n, 4), dtype=torch.int32, device=bufs.device)
    from .build import launch
    with torch.cuda.device(bufs.device):
        launch("brace_scan", bufs.data_ptr(), lengths.data_ptr(),
               out.data_ptr(), n, ms,
               torch.cuda.current_stream(bufs.device).cuda_stream)
    return out


def brace_scan_reference(bufs: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel, batched torch on any device."""
    EVENTS.count("plain.brace_scan")
    n, ms = bufs.shape
    if ms == 0:
        out = torch.zeros((n, 4), dtype=torch.int32, device=bufs.device)
        out[:, 2:] = -1
        return out
    pos = torch.arange(ms, dtype=torch.int32, device=bufs.device)[None, :]
    in_range = pos < lengths[:, None]
    prev = torch.nn.functional.pad(bufs[:, :-1], (1, 0))
    hidden = ((bufs == BRACE_OPEN) | (bufs == BRACE_CLOSE)) \
        & (prev == BACKSLASH)
    open_vis = (bufs == BRACE_OPEN) & ~hidden & in_range
    close_vis = (bufs == BRACE_CLOSE) & ~hidden & in_range
    n_open = open_vis.sum(dim=1, dtype=torch.int32)
    n_close = close_vis.sum(dim=1, dtype=torch.int32)
    outer = torch.where(open_vis, pos, -1).amax(dim=1)
    after = close_vis & (pos > outer[:, None])
    inner = torch.where(after, pos, ms + 1).amin(dim=1)
    inner = torch.where(inner > ms, -1, inner)
    return torch.stack([n_open, n_close, outer, inner], dim=1).to(
        torch.int32)
