"""Data-parallel split of a turbo batch over several devices.

The counterpart of ``interpolation_engine_tpu/parallel/mesh.py`` (turbo
part). Program instances never interact, so a batch splits over a 1-D mesh
of devices with no collectives: each device steps its own rows, and traffic
between devices and the host happens only when the ring gathers parked rows
and scatters them back (SURVEY §2.4).

A mesh is an ordered tuple of ``torch.device``s; a device may repeat (four
shards on one card, or ``["cpu"] * 4`` in the tests). Shard s holds the
global rows ``[offsets[s], offsets[s + 1])`` in order, split as
``torch.tensor_split`` splits, as ``shard_map``'s ``P(axis)`` blocks do
when they divide evenly. Every shard tensor is its own contiguous tensor on
its device (the step kernel takes no views): ``regs`` and ``out`` split on
axis 0, ``sbuf`` and ``meta`` on axis 1, their instance axis.

The general engine's ``shard_batch``, ``replicate`` and
``batched_run_sharded`` are not here yet (ROADMAP Queue 1, the general
engine over a mesh).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# the instance axis of each TurboBatch field (regs, sbuf, out, meta)
INSTANCE_AXIS = (0, 1, 0, 1)


class ShardedTurboBatch(NamedTuple):
    shards: tuple    # one TurboBatch per mesh device, in mesh order
    offsets: tuple   # the global row of each shard's first row, then N

    @property
    def n(self) -> int:
        return self.offsets[-1]

    def parts(self) -> list:
        """(shard, global row of its first row) pairs."""
        return list(zip(self.shards, self.offsets))


def _normalize(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int = None, devices=None) -> tuple:
    """The mesh's devices: ``devices`` as given (a device may repeat), or
    every visible CUDA card; the first ``n_devices`` of them."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device for the mesh (pass devices= "
                               "to build one on other devices)")
        devices = [torch.device("cuda", i) for i in range(count)]
    mesh = tuple(_normalize(d) for d in devices)
    if n_devices is not None:
        if not 0 < n_devices <= len(mesh):
            raise ValueError(f"{n_devices} devices of a mesh of {len(mesh)}")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("a mesh needs a device")
    return mesh


def shard_turbo_batch(batch, mesh) -> ShardedTurboBatch:
    """Split a TurboBatch over the mesh; each shard is copied to its
    device as a tensor of its own."""
    n = int(batch.regs.shape[0])
    if n < len(mesh):
        raise ValueError(f"{n} instances cannot fill {len(mesh)} shards")
    sizes = [len(part) for part in torch.tensor_split(torch.arange(n),
                                                      len(mesh))]
    offsets = [0]
    for size in sizes:
        offsets.append(offsets[-1] + size)
    shards = []
    for s, dev in enumerate(mesh):
        a, b = offsets[s], offsets[s + 1]
        shards.append(type(batch)(*(
            t.narrow(axis, a, b - a).to(dev, copy=True,
                                        memory_format=torch.contiguous_format)
            for t, axis in zip(batch, INSTANCE_AXIS))))
    return ShardedTurboBatch(tuple(shards), tuple(offsets))


def unshard(batch: ShardedTurboBatch):
    """The shards as one TurboBatch on the first shard's device."""
    dev = batch.shards[0].regs.device
    cls = type(batch.shards[0])
    return cls(*(torch.cat([shard[f].to(dev) for shard in batch.shards],
                           dim=axis)
                 for f, axis in enumerate(INSTANCE_AXIS)))
