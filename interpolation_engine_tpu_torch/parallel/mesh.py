"""Data-parallel split of a batch of either engine over several devices.

The counterpart of ``interpolation_engine_tpu/parallel/mesh.py``. Program
instances never interact, so a batch splits over a 1-D mesh of devices
with no collectives: each device steps its own rows, and traffic between
devices and the host happens only when the ring gathers parked rows and
scatters them back (SURVEY §2.4).

A mesh is an ordered tuple of ``torch.device``s; a device may repeat (four
shards on one card, or ``["cpu"] * 4`` in the tests). Shard s holds the
global rows ``[offsets[s], offsets[s + 1])`` in order, split as
``torch.tensor_split`` splits, as ``shard_map``'s ``P(axis)`` blocks do
when they divide evenly. Every shard tensor is its own contiguous tensor on
its device (the step kernel takes no views): ``regs`` and ``out`` split on
axis 0, ``sbuf`` and ``meta`` on axis 1, their instance axis.

The general engine's batch (``vm.state.VMBatch``) splits every field on
axis 0 (``shard_batch``), with the same ``offsets``. ``replicate`` builds
the port's ``GeneralStep`` (the program's tables there) once on each
distinct device, and ``batched_run_sharded`` steps each shard with its
device's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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


class ShardedVMBatch(NamedTuple):
    shards: tuple    # one vm.state.VMBatch per mesh device, in mesh order
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


def _split(batch, n: int, mesh, axes) -> tuple:
    """The shards of ``batch`` (n rows; field f's instance axis axes[f]),
    each a contiguous copy on its mesh device, and the offsets."""
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
            for t, axis in zip(batch, axes))))
    return tuple(shards), tuple(offsets)


def shard_turbo_batch(batch, mesh) -> ShardedTurboBatch:
    """Split a TurboBatch over the mesh; each shard is copied to its
    device as a tensor of its own."""
    return ShardedTurboBatch(*_split(batch, int(batch.regs.shape[0]), mesh,
                                     INSTANCE_AXIS))


def shard_batch(batch, mesh) -> ShardedVMBatch:
    """Split a general-engine VMBatch over the mesh on its leading instance
    axis (every field), each shard a tensor of its own on its device. The
    rows keep their fields, so each instance keeps its ``rng`` (its
    ``random_choice`` seed, its global row + 1 from ``make_instances``)."""
    return ShardedVMBatch(*_split(batch, batch.n, make_mesh(devices=mesh),
                                  (0,) * len(batch)))


def unshard(batch):
    """The shards as one batch on the first shard's device."""
    first = batch.shards[0]
    dev = first[0].device
    axes = INSTANCE_AXIS if isinstance(batch, ShardedTurboBatch) \
        else (0,) * len(first)
    return type(first)(*(torch.cat([shard[f].to(dev)
                                    for shard in batch.shards], dim=axis)
                         for f, axis in enumerate(axes)))


def replicate(compiled, cfg, mesh) -> dict:
    """The general step of ``compiled`` under ``cfg`` on each distinct
    device of the mesh, its tables uploaded there once: device ->
    ``vm.step.GeneralStep``."""
    from ..vm.step import GeneralStep
    return {dev: GeneralStep(compiled, cfg, dev)
            for dev in dict.fromkeys(make_mesh(devices=mesh))}


def batched_run_sharded(mesh):
    """``run(batch, steps, n_steps) -> batch``: n_steps general-engine
    steps of every RUNNING row of a ``ShardedVMBatch``, each shard with
    ``steps[its device]`` (a ``replicate``). One worker thread per distinct
    device takes that device's shards in order; every device's work is
    queued before the host waits on any (a step reads its pcs to the
    host, so shards on different cards overlap only this way). The input
    batch is not changed."""
    mesh = make_mesh(devices=mesh)

    def run(batch: ShardedVMBatch, steps: dict, n_steps: int):
        by_dev: dict = {}
        for s, shard in enumerate(batch.shards):
            dev = shard.pc.device
            if dev not in mesh:
                raise ValueError(f"shard {s} on {dev}, not on the mesh "
                                 f"{list(mesh)}")
            by_dev.setdefault(dev, []).append(s)

        def work(dev, ss):
            guard = torch.cuda.device(dev) if dev.type == "cuda" \
                else contextlib.nullcontext()
            with guard:
                return [(s, steps[dev].run(batch.shards[s], n_steps))
                        for s in ss]

        if len(by_dev) == 1:
            done = work(*next(iter(by_dev.items())))
        else:
            with concurrent.futures.ThreadPoolExecutor(len(by_dev)) as ex:
                futures = [ex.submit(work, dev, ss)
                           for dev, ss in by_dev.items()]
                done = [pair for f in futures for pair in f.result()]
        out = [None] * len(batch.shards)
        for s, shard in done:
            out[s] = shard
        return ShardedVMBatch(tuple(out), batch.offsets)
    return run
