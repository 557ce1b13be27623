"""The device engines' driver: the general engine's ``DeviceRunner`` with its
host IO ring, and the CLI entry ``run_program_on_device``.

The counterpart of the JAX package's ``vm/driver.py``. ``DeviceRunner``
runs one compiled program over a batch of instances (``vm/step.py``): an
instance that meets a blocking or device-unsupported instruction parks, and
the ring decodes its row, executes the original task with the exact host
executor, re-encodes (which also compacts the arena) and resumes it. It has
no AOT cache and no eager mode: both exist in the JAX package only for
XLA's compile time.

``run_program_on_device`` runs a ``host_only`` program on the host engine,
every program the turbo planner accepts on the turbo engine, and a program
the planner rejects (``NotTurbo``) on the general engine, which has every
opcode. The turbo engine also hands its escapes (instances no turbo batch
can hold) to one ``DeviceRunner`` that shares its LaneRing.
"""

from __future__ import annotations

import asyncio
import glob
import os
import time
from typing import Callable

import numpy as np
import torch

from .._shared import (compile_program, context, events, executor,
                       host_interp, io_manager, json5, loader, runtime,
                       vm_config)
from .._shared import lanering as lanering_mod
from ..ops.interp_kernel import ERR_CAPACITY
from . import state as vs
from .step import GeneralStep
from .turbo import InstanceResult, NotTurbo, TurboConfig, TurboEngine

RUNNING, PARKED = vm_config.RUNNING, vm_config.PARKED


class DeviceRunner:
    """Run one compiled program over a batch of instances on ``device``
    (a CUDA device runs the brace scan's kernel, the CPU its plain
    version).

    ``lanering`` is a LaneRing to share: the turbo engine that escapes
    instances into this runner passes its own, so their lanes' IO in
    flight survives the move. ``instance_ids`` are the global instance ids
    of the batch rows (the row itself by default), the shared LaneRing's
    keys; this runner sweeps and cancels the pending IO of its own ids
    only. ``io_factory`` still takes the row."""

    def __init__(self, compiled, cfg=None, io_factory: Callable = None, *,
                 device, lanering=None, instance_ids=None):
        self.compiled = compiled
        self.instance_ids = list(instance_ids) if instance_ids else None
        self._row_index = None if self.instance_ids is None else {
            gid: row for row, gid in enumerate(self.instance_ids)}
        self.cfg = cfg or vm_config.VMConfig()
        self.device = torch.device(device)
        self.step = GeneralStep(compiled, self.cfg, self.device)
        self.io_factory = io_factory or (lambda i: io_manager.IOManager(
            io_manager.BufferBackend()))
        self.total_device_steps = 0
        if compiled.needs_threads > self.cfg.max_threads:
            raise ValueError(
                f"program spawns {compiled.needs_threads} parallel threads "
                f"but cfg.max_threads={self.cfg.max_threads}")
        self._lanering = lanering if lanering is not None \
            else lanering_mod.LaneRing(compiled)
        # capacity-cliff telemetry: how often programs outgrow the
        # VMConfig limits and go through the ring. ring_ms is the wall time
        # of the ring rounds (gather, host service overlapped with the
        # launch of the RUNNING rows, scatter); service_ms the host service
        # alone, from the gather to its last serviced row
        self.ring_stats = {"rounds": 0, "parks": 0, "capacity_parks": 0,
                           "parks_by_kind": {}, "ring_ms": 0.0,
                           "service_ms": 0.0}

    def launch(self, batch: vs.VMBatch, inner_steps: int) -> vs.VMBatch:
        """``inner_steps`` steps of every RUNNING row (the JAX runner's
        ``_jitted``)."""
        return self.step.run(batch, inner_steps)

    # ---- instance lifecycle -------------------------------------------------

    def make_instances(self, n: int, args=()) -> vs.VMBatch:
        """n identical fresh instances with distinct PRNG streams: one
        encoded prototype, broadcast on the device."""
        program = self.compiled.program
        inserts = self._inserts_dir_values()
        inserts.update(program["default_state"]["inserts"])
        ctx = context
        for i, arg in enumerate(args, start=1):
            inserts[f"ARG{i}"] = (
                arg.replace(ctx.INSERT_START, ctx.ESCAPE + ctx.INSERT_START)
                   .replace(ctx.INSERT_STOP, ctx.ESCAPE + ctx.INSERT_STOP))
        proto = vs.encode_instance(inserts, self.cfg, pc=0, rng=1)
        batch = vs.broadcast_row(proto, n, self.device)
        return batch._replace(rng=torch.arange(
            1, n + 1, dtype=torch.int64, device=self.device))

    def _inserts_dir_values(self) -> dict:
        """--inserts-dir files, preloaded into the store below the
        program's own defaults (the host resolves them lazily with lower
        precedence). A program that deletes such a key would still see the
        directory's value on the host: a divergence kept from the JAX
        package."""
        values: dict = {}
        if not context.CTX.inserts_dir:
            return values
        for path in glob.glob(os.path.join(context.CTX.inserts_dir, "*")):
            name = os.path.basename(path)
            try:
                with open(path) as f:
                    text = f.read()
                if name.endswith(".json5"):
                    values[name[:-len(".json5")]] = \
                        host_interp.recursive_escape(json5.loads(text))
                else:
                    values[name] = host_interp.recursive_escape(text.strip())
            except (OSError, ValueError):
                continue
        return values

    # ---- host ring ----------------------------------------------------------

    def _gid(self, row: int) -> int:
        """Global instance id of a batch row, the LaneRing's key."""
        return self.instance_ids[row] if self.instance_ids else row

    def _row_of(self, gid: int, n: int):
        """Batch row of a global id, or None when this runner does not own
        it (a sibling engine's pending IO is not swept here)."""
        if self._row_index is not None:
            return self._row_index.get(gid)
        return gid if 0 <= gid < n else None

    async def _sweep_pending(self, epochs: np.ndarray,
                             status: np.ndarray) -> None:
        """Cancel the host IO of this runner's finished parallel blocks: a
        race won on the device bumps the row's par_epoch, and the losers'
        IO must go (the reference cancels after FIRST_COMPLETED)."""
        for gid in list(self._lanering.pending):
            row = self._row_of(gid, len(status))
            pend = self._lanering.pending.get(gid)
            if row is None or pend is None:
                continue
            if int(epochs[row]) != pend["epoch"] or \
                    status[row] not in (RUNNING, PARKED):
                await self._lanering.cancel(gid)

    def _runtime_for(self, i: int, rts: dict):
        return rts.setdefault(i, executor.Runtime(
            self.io_factory(i),
            self.compiled.program.get("completion_args", {}),
            self.compiled.program.get("named_tasks", {})))

    async def _service_instance(self, st: dict, i: int, rts: dict) -> dict:
        """Service one parked row (a dict of host arrays); returns the row
        to write back."""
        pc = int(st["park_arg"])
        kind = int(st["park_kind"])
        if kind == vm_config.PARK_THREADS:
            return await self._service_threads(st, i, rts)
        task = self.compiled.source_tasks[pc]
        inserts = vs.decode_inserts(st)
        state = {"inserts": inserts, "output": vs.decode_output(st)}
        if kind == vm_config.PARK_AWAIT_INSERT and task is not None:
            if lanering_mod.await_insert_ready(task, inserts):
                return self._resume(st, state, pc + 1)
            return st  # still parked
        if task is None:
            raise RuntimeError(f"instance {i}: parked at pc={pc} with no "
                               f"source task")
        rt = self._runtime_for(i, rts)
        counters = np.asarray(st["counters"]).copy()
        next_pc = await self._lanering.exec_parked(rt, state, pc, task, i,
                                                   kind, counters)
        return self._resume(st, state, next_pc, counters=counters)

    async def _service_threads(self, st: dict, i: int, rts: dict) -> dict:
        """Service a row parked inside a parallel block through the shared
        asyncio event-loop twin (vm/lanering.py)."""
        view = {
            "tstate": np.asarray(st["tstate"]).copy(),
            "tpc": np.asarray(st["tpc"]).copy(),
            "tpark_kind": np.asarray(st["tpark_kind"]),
            "tpark_arg": np.asarray(st["tpark_arg"]),
            "counters": np.asarray(st["counters"]).copy(),
            "state": {"inserts": vs.decode_inserts(st),
                      "output": vs.decode_output(st)},
            "cur": int(st["cur_tid"]),
            "par_mode": int(st["par_mode"]),
            "par_join": int(st["par_join"]),
            "par_epoch": int(st["par_epoch"]),
        }
        rt = self._runtime_for(i, rts)
        res = await self._lanering.service(rt, self._gid(i), view)
        if res == "parked":
            return st
        state, counters = view["state"], view["counters"]
        steps = int(st["steps"]) + 1
        if res == "complete":
            fresh = vs.encode_instance(
                state["inserts"], self.cfg, output=state["output"],
                pc=int(st["par_join"]), counters=counters,
                rng=int(st["rng"]), steps=steps)
            fresh.update(status=np.int32(RUNNING),
                         par_epoch=np.int32(int(st["par_epoch"]) + 1))
            return fresh
        nxt = view["cur"]
        fresh = vs.encode_instance(state["inserts"], self.cfg,
                                   output=state["output"],
                                   pc=int(view["tpc"][nxt]),
                                   counters=counters, rng=int(st["rng"]),
                                   steps=steps)
        fresh.update(status=np.int32(RUNNING),
                     tpc=np.asarray(view["tpc"], np.int32),
                     tstate=np.asarray(view["tstate"], np.int32),
                     tpark_kind=st["tpark_kind"], tpark_arg=st["tpark_arg"],
                     cur_tid=np.int32(nxt), par_mode=st["par_mode"],
                     par_join=st["par_join"], par_epoch=st["par_epoch"])
        return fresh

    def _resume(self, st: dict, state: dict, next_pc: int,
                counters=None) -> dict:
        fresh = vs.encode_instance(
            state["inserts"], self.cfg, output=state["output"], pc=next_pc,
            counters=(np.asarray(st["counters"]) if counters is None
                      else counters),
            rng=int(st["rng"]), steps=int(st["steps"]) + 1)
        # thread lanes survive the re-encode (par_epoch must stay
        # monotonic for the pending-IO cancel sweep)
        fresh.update(status=np.int32(RUNNING),
                     **{k: st[k] for k in ("tpc", "tstate", "tpark_kind",
                                           "tpark_arg", "cur_tid",
                                           "par_mode", "par_join",
                                           "par_epoch")})
        return fresh

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        return t.to("cpu", copy=True).numpy()

    async def _service_all(self, sub: dict, parked: np.ndarray,
                           rts: dict) -> list:
        """Service every gathered row; adds the wall time from the first
        row's start to the last row's end to ``service_ms``."""
        t0 = time.perf_counter()
        out = await asyncio.gather(*[
            self._service_instance(vs.row_of(sub, j), int(i), rts)
            for j, i in enumerate(parked)])
        self.ring_stats["service_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    async def run_async(self, batch: vs.VMBatch, *, inner_steps: int = 64,
                        max_rounds: int = 10_000) -> vs.VMBatch:
        """Launch, cancel the IO of finished parallel blocks, gather every
        parked row to the host, launch again for the RUNNING rows on a
        worker thread while the event loop services the parked ones (a
        parked row is frozen in the step), and scatter the serviced rows
        back; until no row is RUNNING or PARKED."""
        rts: dict = {}
        stalled_rounds = 0
        loop = asyncio.get_running_loop()
        for round_no in range(max_rounds):
            batch = self.launch(batch, inner_steps)
            status = self._host(batch.status)
            self.total_device_steps += inner_steps
            if self._lanering.pending:
                await self._sweep_pending(self._host(batch.par_epoch),
                                          status)
            parked = np.nonzero(status == PARKED)[0]
            if len(parked) == 0:
                if not (status == RUNNING).any():
                    break
                continue
            # one gather of every parked row, host service, one scatter
            t_ring = time.perf_counter()
            idx = torch.from_numpy(parked.astype(np.int64)).to(self.device)
            sub = batch.take(idx).to_numpy()
            service = asyncio.ensure_future(self._service_all(sub, parked,
                                                              rts))
            if (status == RUNNING).any():
                batch = await loop.run_in_executor(None, self.launch, batch,
                                                   inner_steps)
                self.total_device_steps += inner_steps
            serviced = await service
            resumed = 0
            for j, st_out in enumerate(serviced):
                if int(st_out["status"]) == PARKED:
                    continue
                resumed += 1
                self.ring_stats["parks"] += 1
                k = int(sub["park_kind"][j])
                by = self.ring_stats["parks_by_kind"]
                by[k] = by.get(k, 0) + 1
                if int(sub["last_err"][j]) == ERR_CAPACITY:
                    self.ring_stats["capacity_parks"] += 1
            back = vs.stack_rows(serviced, self.device)
            batch = vs.VMBatch(*(t.index_copy(0, idx, s)
                                 for t, s in zip(batch, back)))
            ring_ms = (time.perf_counter() - t_ring) * 1e3
            self.ring_stats["rounds"] = round_no + 1
            self.ring_stats["ring_ms"] += ring_ms
            events.EVENTS.emit(events.VM_ROUND, round=round_no,
                               engine="general",
                               running=int((status == RUNNING).sum()),
                               parked=len(parked), resumed=resumed,
                               ring_ms=round(ring_ms, 3))
            status = self._host(batch.status)
            if not ((status == RUNNING) | (status == PARKED)).any():
                break
            if not (status == RUNNING).any() and resumed == 0:
                # every live instance parked and nothing unblocked
                # (await_insert with no writer): retry a few times, then
                # give up
                stalled_rounds += 1
                if stalled_rounds > 50:
                    break
                await asyncio.sleep(0.05)
            else:
                stalled_rounds = 0
        for gid in list(self._lanering.pending):
            if self._row_of(gid, batch.n) is not None:
                await self._lanering.cancel(gid)
        s = self.ring_stats
        events.EVENTS.emit(events.VM_STATS, engine="general",
                           rounds=s["rounds"], parks=s["parks"],
                           capacity_parks=s["capacity_parks"],
                           parks_by_kind={str(k): v for k, v
                                          in s["parks_by_kind"].items()},
                           ring_ms=round(s["ring_ms"], 3),
                           service_ms=round(s["service_ms"], 3),
                           device_steps=self.total_device_steps)
        return batch

    def run(self, batch: vs.VMBatch, **kw) -> vs.VMBatch:
        return asyncio.run(self.run_async(batch, **kw))

    def results(self, batch: vs.VMBatch) -> list:
        host = batch.to_numpy()
        out = []
        for i in range(batch.n):
            st = vs.row_of(host, i)
            out.append(InstanceResult(
                output=vs.decode_output(st), inserts=vs.decode_inserts(st),
                status=int(st["status"]), steps=int(st["steps"])))
        return out


def run_program_on_device(filepath: str, args: list, io, batch: int = 1,
                          tcfg: TurboConfig = None) -> int:
    """Run ``batch`` instances of the program on the first CUDA device and
    print instance 0's final output, stripped, like the host CLI.

    The JAX package tries the turbo engine only from 256 instances up,
    because its TPU compile takes minutes; the turbo kernel here builds in
    seconds, so every program the planner accepts runs on it. A kernel that
    fails fails the run: nothing falls back to another engine."""
    context.CTX.program_dir = os.path.dirname(os.path.abspath(filepath))
    program, _state = loader.load(filepath)
    compiled = compile_program(program)
    if compiled.host_only:
        asyncio.run(runtime.async_main(filepath, list(args), io))
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("the device engine needs a CUDA device")
    try:
        engine = TurboEngine(compiled, tcfg, io_factory=lambda i: io,
                             device="cuda")
    except NotTurbo:
        engine = None
    if engine is not None:
        final = engine.run(engine.make_batch(batch, list(args)))
        results = engine.results(final, batch)
    else:
        runner = DeviceRunner(compiled, io_factory=lambda i: io,
                              device="cuda")
        final = runner.run(runner.make_instances(batch, list(args)))
        results = runner.results(final)
    print(results[0].output.strip())
    return 0
