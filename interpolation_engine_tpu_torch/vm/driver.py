"""The device engines' driver: the general engine's ``DeviceRunner`` with its
host IO ring, the interactive single-instance run ``DeviceProgramRun``, the
CLI entry ``run_program_on_device``, and the reference-format cursor chains
that save and resume use on both engines.

The counterpart of the JAX package's ``vm/driver.py``. ``DeviceRunner``
runs one compiled program over a batch of instances (``vm/step.py``): an
instance that meets a blocking or device-unsupported instruction parks, and
the ring decodes its row, executes the original task with the exact host
executor, re-encodes (which also compacts the arena) and resumes it. The
batch may be split over a mesh (``parallel.mesh.shard_batch``): each shard
steps on its own device, and the ring reads and writes the shards by
global row. It has no AOT cache and no eager mode: both exist in the JAX
package only for XLA's compile time.

``run_program_on_device`` runs a ``host_only`` program on the host engine.
At batch 1 it runs ``DeviceProgramRun`` on the general engine, with the
reference's Esc menu (Save State, Load State, Reload and Restart, Quit),
unless ``IE_TPU_TURBO=1``. At larger batches every program the turbo
planner accepts runs on the turbo engine, and a program the planner rejects
(``NotTurbo``) on the general engine, which has every opcode;
``IE_TPU_TURBO=0`` sends every batch to the general engine. The turbo
engine also hands its escapes (instances no turbo batch can hold) to one
``DeviceRunner`` that shares its LaneRing.

Save and resume speak the reference's state dicts: ``order_index`` and the
nested ``order_index/<path>`` cursors (``.../counter`` for a ``for``),
built from a pc and the loop counters by ``emit_cursors`` and
``emit_par_cursors``, and resolved back to a pc by ``pc_of_state``. Both
engines of both packages, and the host engine, load each other's saves.
"""

from __future__ import annotations

import asyncio
import copy
import glob
import os
import signal
from typing import Callable

import numpy as np
import torch

from .._shared import (compile_program, context, events, executor,
                       host_interp, io_manager, isa, json5, loader, planner,
                       runtime, vm_config)
from .._shared import lanering as lanering_mod
from ..core.persistence import save_program
from ..io import tts as tts_mod
from ..ops.interp_kernel import ERR_CAPACITY
from ..parallel.mesh import ShardedVMBatch, batched_run_sharded
from . import state as vs
from .step import GeneralStep
from .turbo import (InstanceResult, NotTurbo, TurboConfig, TurboEngine,
                    base_config)

RUNNING, PARKED = vm_config.RUNNING, vm_config.PARKED
T_NEW, T_READY, T_WAIT = (vm_config.T_NEW, vm_config.T_READY,
                          vm_config.T_WAIT)


class DeviceRunner:
    """Run one compiled program over a batch of instances on ``device``
    (a CUDA device runs the brace scan's kernel, the CPU its plain
    version).

    ``lanering`` is a LaneRing to share: the turbo engine that escapes
    instances into this runner passes its own, so their lanes' IO in
    flight survives the move. ``instance_ids`` are the global instance ids
    of the batch rows (the row itself by default), the shared LaneRing's
    keys; this runner sweeps and cancels the pending IO of its own ids
    only. ``io_factory`` still takes the row.

    A ``ShardedVMBatch`` (``parallel.mesh.shard_batch``) runs each shard on
    its own device (``launch``); the ring's row numbers are global rows,
    ``offsets[s] + j`` for row j of shard s, and ``results`` come back in
    global order."""

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
        self._steps: dict = {}   # device -> its GeneralStep (sharded)

    def launch(self, batch, inner_steps: int):
        """``inner_steps`` steps of every RUNNING row (the JAX runner's
        ``_jitted``); a sharded batch steps every shard on its device,
        with this program's ``GeneralStep`` built there once."""
        if not isinstance(batch, ShardedVMBatch):
            return self.step.run(batch, inner_steps)
        mesh = tuple(shard.pc.device for shard in batch.shards)
        for dev in mesh:
            if dev not in self._steps:
                self._steps[dev] = self.step if dev == self.step.device \
                    else GeneralStep(self.compiled, self.cfg, dev)
        return batched_run_sharded(mesh)(batch, self._steps, inner_steps)

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

    async def _service_all(self, sub: dict, parked: np.ndarray,
                           rts: dict) -> list:
        """Service every gathered row; adds the wall time from the first
        row's start to the last row's end to ``service_ms``."""
        t0 = events.now_us()
        out = await asyncio.gather(*[
            self._service_instance(vs.row_of(sub, j), int(i), rts)
            for j, i in enumerate(parked)])
        self.ring_stats["service_ms"] += (events.now_us() - t0) / 1e3
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
            status = _column(batch, "status")
            self.total_device_steps += inner_steps
            if self._lanering.pending:
                await self._sweep_pending(_column(batch, "par_epoch"),
                                          status)
            parked = np.nonzero(status == PARKED)[0]
            if len(parked) == 0:
                if not (status == RUNNING).any():
                    break
                continue
            # one gather of every parked row, host service, one scatter
            t_ring = events.now_us()
            sub, idx = _gather(batch, parked)
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
            batch = _scatter(batch, idx, serviced)
            ring_ms = (events.now_us() - t_ring) / 1e3
            self.ring_stats["rounds"] = round_no + 1
            self.ring_stats["ring_ms"] += ring_ms
            events.EVENTS.emit(events.VM_ROUND, round=round_no,
                               engine="general",
                               running=int((status == RUNNING).sum()),
                               parked=len(parked), resumed=resumed,
                               ring_ms=round(ring_ms, 3))
            status = _column(batch, "status")
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

    def results(self, batch) -> list:
        """Every row's result, in global order."""
        host = _host_rows(batch)
        out = []
        for i in range(batch.n):
            st = vs.row_of(host, i)
            out.append(InstanceResult(
                output=vs.decode_output(st), inserts=vs.decode_inserts(st),
                status=int(st["status"]), steps=int(st["steps"])))
        return out

    # ---- save/load (reference-format state dicts) ----------------------------

    def export_state(self, batch, i: int) -> dict:
        """Row i as the reference's runtime-state dict: inserts, output,
        ``order_index`` and the nested cursors rebuilt from (pc, loop
        counters); inside a parallel block, each lane's chain. The inverse
        of ``load_state``."""
        sub, _ = _gather(batch, np.asarray([i]))
        st = vs.row_of(sub, 0)
        pc = min(int(st["pc"]), self.compiled.n_instr - 1)
        counters = np.asarray(st["counters"])
        state = {"inserts": vs.decode_inserts(st),
                 "output": vs.decode_output(st)}
        if int(st["par_mode"]) > 0:
            emit_par_cursors(self.compiled, state, st, counters)
        else:
            emit_cursors(self.compiled, state, pc, counters)
        return state

    def save_to_program(self, batch, i: int, slot: str, label: str,
                        filepath: str) -> None:
        """Splice row i's state into the program file's ``save_states``
        under ``slot``, keeping its comments and formatting (the host
        menu's Save State)."""
        state = self.export_state(batch, i)
        state["label"] = label
        self.compiled.program.setdefault("save_states", {})[str(slot)] = state
        save_program(self.compiled.program, filepath)

    def load_state(self, state: dict, *, seed: int = 0) -> dict:
        """A reference-format state dict as one codec row (stack it with
        ``vs.stack_rows``). The cursor chain resolves to the innermost
        task's pc and the for-counters land in ``counters``; a state saved
        inside a parallel block re-seeds its lanes at their resume pcs, all
        ``T_NEW``, as the host re-runs the block. Cursors below a host-op
        task raise ``ValueError``."""
        counters = np.zeros((self.cfg.max_loops,), np.int32)
        pc, leftovers, par = pc_of_state(self.compiled, state, counters)
        if leftovers:
            raise ValueError(
                f"state has block cursors below a host-op task "
                f"{sorted(leftovers)}; resume requires the host engine")
        row = vs.encode_instance(dict(state.get("inserts", {})), self.cfg,
                                 output=state.get("output", ""), pc=pc,
                                 counters=counters, rng=seed)
        if par is not None:
            nt = self.cfg.max_threads
            tpc = np.zeros((nt,), np.int32)
            tstate = np.zeros((nt,), np.int32)
            for lane in range(min(par["k"], nt)):
                tpc[lane] = par["tpc"][lane]
                tstate[lane] = T_NEW
            row.update(pc=np.int32(tpc[0]), tpc=tpc, tstate=tstate,
                       cur_tid=np.int32(0), par_mode=np.int32(par["mode"]),
                       par_join=np.int32(par["join_pc"]))
        return row

    def pc_of_order_index(self, order_index: int) -> int:
        """The first instruction of the 1-based top-level task index."""
        for pc, oi in enumerate(self.compiled.order_index_of):
            if oi >= order_index and self.compiled.scope_of[pc] == 0:
                return pc
        return len(self.compiled.order_index_of) - 1   # the HALT


def _parts(batch) -> list:
    """(shard, global row of its first row) of a VMBatch (one shard) or a
    ShardedVMBatch."""
    if isinstance(batch, ShardedVMBatch):
        return batch.parts()
    return [(batch, 0)]


def _column(batch, name: str) -> np.ndarray:
    """One field of every row, on the host, in global order."""
    return np.concatenate([getattr(shard, name).to("cpu", copy=True).numpy()
                           for shard, _ in _parts(batch)])


def _host_rows(batch) -> dict:
    """Every field of every row as host arrays (JAX dtypes), global order."""
    parts = [shard.to_numpy() for shard, _ in _parts(batch)]
    return {f: np.concatenate([p[f] for p in parts]) for f in vs.FIELDS}


def _gather(batch, rows: np.ndarray) -> tuple:
    """Host copies of the given global rows (sorted), and where each
    shard's part of them lies: (shard position, local rows on its device,
    first and last index into ``rows``)."""
    parts, idx = [], []
    for s, (shard, off) in enumerate(_parts(batch)):
        lo, hi = np.searchsorted(rows, [off, off + shard.n])
        if lo == hi:
            continue
        local = torch.from_numpy((rows[lo:hi] - off).astype(np.int64)).to(
            shard.pc.device)
        parts.append(shard.take(local).to_numpy())
        idx.append((s, local, lo, hi))
    sub = {f: np.concatenate([p[f] for p in parts]) for f in vs.FIELDS}
    return sub, idx


def _scatter(batch, idx: list, rows: list):
    """``batch`` with the gathered rows replaced by ``rows`` (codec row
    dicts in the gather's order), as a new batch."""
    shards = [shard for shard, _ in _parts(batch)]
    for s, local, lo, hi in idx:
        back = vs.stack_rows(rows[lo:hi], shards[s].pc.device)
        shards[s] = vs.VMBatch(*(t.index_copy(0, local, b)
                                 for t, b in zip(shards[s], back)))
    if isinstance(batch, ShardedVMBatch):
        return ShardedVMBatch(tuple(shards), batch.offsets)
    return shards[0]


class DeviceProgramRun:
    """One interactive instance on the general engine, with the reference's
    Esc menu (Save State, Load State, Reload and Restart, Quit), the JAX
    package's ``DeviceProgramRun``.

    Esc (SIGINT, or a backend's ``on_menu``) cancels the round in flight,
    stepping or host service, and opens the menu; closing it services the
    still-parked instruction again, as the host re-executes a cancelled
    task. A round writes the serviced row back only once its service has
    completed, so a cancelled round leaves ``batch`` as it was. Save
    exports the row in the reference's cursor format, spliced into the
    program file; Load encodes any reference-format slot back onto the
    device."""

    def __init__(self, filepath: str, args: list, io, inner_steps: int = 16,
                 *, device="cuda"):
        self.filepath = filepath
        self.args = list(args)
        self.io = io
        self.inner_steps = inner_steps
        self.device = device
        self.killme = False
        self.menu_open = False
        self.current_task = None
        self.runner = None
        self.batch = None

    def toggle_menu(self) -> None:
        if self.current_task:
            self.current_task.cancel()
        self.menu_open = not self.menu_open

    def kill(self) -> None:
        self.killme = True
        if self.current_task:
            self.current_task.cancel()

    def _make_runner(self) -> None:
        program, _state = loader.load(self.filepath)
        compiled = compile_program(program)
        if compiled.host_only:
            raise ValueError(
                f"host-only program: {compiled.host_only_reason}")
        self.runner = DeviceRunner(compiled, io_factory=lambda i: self.io,
                                   device=self.device)
        self.batch = self.runner.make_instances(1, self.args)

    async def run(self) -> str:
        context.CTX.program_dir = os.path.dirname(
            os.path.abspath(self.filepath))
        self._make_runner()
        await self.io.start()
        await asyncio.sleep(0)
        await self.io.write("")
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGINT, self.toggle_menu)
        except (NotImplementedError, RuntimeError):
            pass   # not the main thread, or no signals on this platform
        backend = getattr(self.io, "backend", None)
        if backend is not None and hasattr(backend, "on_menu"):
            backend.on_menu = self.toggle_menu
            backend.on_kill = self.kill
        rts: dict = {}
        while not self.killme:
            if self.menu_open:
                self.current_task = loop.create_task(self._menu())
            else:
                self.current_task = loop.create_task(self._round(rts))
            try:
                await self.current_task
            except asyncio.CancelledError:
                current = asyncio.current_task()
                if current is not None and current.cancelling() > 0:
                    raise
            if not self.menu_open and not self.killme:
                if int(self.batch.status[0]) not in (RUNNING, PARKED):
                    break
        result = self.runner.results(self.batch)[0]
        await self.io.stop()
        tts_mod.stop_current_tts()
        print(result.output.strip())   # the reference's own final print
        return result.output

    async def _round(self, rts: dict) -> None:
        """One launch, then the host service of the parked row; a 0.05 s
        idle poll when nothing moved (an await_insert with no writer)."""
        self.batch = self.runner.launch(self.batch, self.inner_steps)
        if int(self.batch.status[0]) != PARKED:
            return
        steps_before = int(self.batch.steps[0])
        st = vs.row_of(self.batch.to_numpy(), 0)
        st_out = await self.runner._service_instance(st, 0, rts)
        self.batch = vs.stack_rows([st_out], self.runner.device)
        if int(st_out["status"]) == PARKED and \
                int(st_out["steps"]) == steps_before:
            await asyncio.sleep(0.05)

    def _slots(self, program: dict) -> list:
        saves = program.setdefault("save_states", {})
        return [saves.get(str(slot), {"label": "(Empty Slot)"})
                for slot in range(1, 10)]

    async def _menu(self) -> None:
        runner = self.runner
        program = runner.compiled.program
        status = ""
        while True:
            options = ["Save State", "Load State", "Reload and Restart",
                       "Quit"]
            choice = options[await self.io.select_index(
                options, description=f"\n{status}")]
            context.log(f"🛈 user picked '{choice}'")

            if choice == "Save State":
                labels = [s["label"] for s in self._slots(program)]
                choice_i = await self.io.select_index(labels,
                                                      description="")
                label = labels[choice_i]
                save_label = await self.io.user_input(
                    prompt="What do you want to call this save state?\n> ",
                    default=label if label != "(Empty Slot)" else "")
                runner.save_to_program(self.batch, 0, str(choice_i + 1),
                                       save_label, self.filepath)
                status = f"\nSaved '{save_label}' to slot {choice_i + 1}.\n"
                context.log(f"🛈 saved slot {choice_i + 1}")

            elif choice == "Load State":
                slots = self._slots(program)
                labels = [s.get("label", "(Unlabelled Slot)") for s in slots]
                choice_i = await self.io.select_index(labels,
                                                      description="")
                if labels[choice_i] == "(Empty Slot)":
                    status = "\nCannot load empty slot.\n"
                    continue
                state = copy.deepcopy(slots[choice_i])
                label = state.pop("label", "")
                try:
                    row = runner.load_state(state)
                except ValueError as e:
                    status = f"\n{e}\n"
                    continue
                self.batch = vs.stack_rows([row], runner.device)
                await self.io.write(state.get("output", ""))
                status = f"\nLoaded '{label}' from slot {choice_i + 1}.\n"
                context.log(f"🛈 Loaded slot {choice_i + 1} ({label}).")

            elif choice == "Reload and Restart":
                loader.invalidate_cache()
                self._make_runner()   # keeps self.args: ARGn re-applied
                status = "\nRestarted Program after reloading.\n"
                context.log("🛈 Restarted Program.")

            elif choice == "Quit":
                self.kill()
                return


def run_program_on_device(filepath: str, args: list, io, batch: int = 1,
                          tcfg: TurboConfig = None, *,
                          device="cuda") -> int:
    """Run ``batch`` instances of the program on ``device`` (the first
    CUDA card unless the caller asks for another) and print instance 0's
    final output, stripped, like the host CLI.

    Batch 1 is the interactive ``DeviceProgramRun`` with its Esc menu, as
    in the JAX package, unless ``IE_TPU_TURBO=1``. ``IE_TPU_TURBO=0`` sends
    every batch to the general engine. Otherwise every program the turbo
    planner accepts runs on the turbo engine at any batch: the JAX package
    tries it only from 256 instances up, because its TPU compile takes
    minutes, but this kernel builds in seconds. Without ``tcfg`` its
    widths are sized from the program's literals (``base_config``: width
    128, 512 or 2048), so a literal up to 2048 bytes stays on the turbo
    engine. A batch whose instance does not fit a block's shared memory on
    the card is ``NotTurbo``, like a program the planner rejects: the
    general engine runs it on the same card. A kernel that fails fails the run: nothing falls back to another
    engine."""
    context.CTX.program_dir = os.path.dirname(os.path.abspath(filepath))
    program, _state = loader.load(filepath)
    compiled = compile_program(program)
    if compiled.host_only:
        asyncio.run(runtime.async_main(filepath, list(args), io))
        return 0
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the device engine needs a CUDA device")
    turbo_env = os.environ.get("IE_TPU_TURBO", "")
    if batch == 1 and turbo_env != "1":
        asyncio.run(DeviceProgramRun(filepath, args, io,
                                     device=device).run())
        return 0
    engine = None
    if turbo_env != "0":
        try:
            plan = planner.plan_turbo(compiled)
            engine = TurboEngine(compiled, tcfg or base_config(plan),
                                 io_factory=lambda i: io, device=device,
                                 plan=plan)
        except NotTurbo:
            engine = None
    if engine is not None:
        final = engine.run(engine.make_batch(batch, list(args)))
        results = engine.results(final, batch)
    else:
        runner = DeviceRunner(compiled, io_factory=lambda i: io,
                              device=device)
        final = runner.run(runner.make_instances(batch, list(args)))
        results = runner.results(final)
    print(results[0].output.strip())
    return 0


# ---------------------------------------------------------------------------
# reference-format cursor chains (shared by DeviceRunner and TurboEngine)
# ---------------------------------------------------------------------------

def _label(task: dict) -> str:
    return task.get("traceback_label",
                    f"{task.get('cmd')}-{task.get('line', 0)}")


def _through_run_task(named_tasks: dict, task: dict, path: str) -> tuple:
    """Follow a chain of ``run_task`` to the task it runs: (task, path). A
    run_task extends the path without a cursor of its own."""
    seen = set()
    while task.get("cmd") == "run_task" and \
            isinstance(task.get("task_name"), str) and \
            task["task_name"] in named_tasks and \
            task["task_name"] not in seen:
        seen.add(task["task_name"])
        task = named_tasks[task["task_name"]]
        path = f"{path}/{_label(task)}"
    return task, path


def emit_cursors(compiled, state: dict, pc: int, counters) -> None:
    """Write the reference's cursor keys for position ``pc``: the 1-based
    ``order_index``, then ``order_index/<path>`` per enclosing block and
    ``.../counter`` per enclosing ``for``, from the loop counters."""
    _walk_cursors(compiled, state, pc, counters, compiled.program["order"],
                  compiled.block_task_pcs.get("", []), None)


def emit_par_cursors(compiled, state: dict, st, counters) -> None:
    """The cursors of a row saved inside a parallel block: the chain down to
    the parallel task, then one chain per lane rooted at its subtask. The
    running lane is at ``pc``, a waiting or ready lane at its ``tpc``; a
    lane that never ran (``T_NEW``) or finished (``T_DONE``) emits nothing,
    as on the host. ``st`` maps pc, status, cur_tid, par_join, tpc and
    tstate to the row's values."""
    block = compiled.par_blocks.get(int(st["par_join"]))
    if block is None:
        emit_cursors(compiled, state,
                     min(int(st["pc"]), compiled.n_instr - 1), counters)
        return
    emit_cursors(compiled, state, block["begin_pc"], counters)
    tstate = np.asarray(st["tstate"])
    tpc = np.asarray(st["tpc"])
    cur = int(st["cur_tid"])
    running = int(st["status"]) == RUNNING
    for lane, (_, entry_pc, sub) in enumerate(block["lanes"]):
        ts = int(tstate[lane]) if lane < len(tstate) else 0
        if running and lane == cur:
            lane_pc = int(st["pc"])
        elif ts in (T_WAIT, T_READY):
            lane_pc = int(tpc[lane])
        else:
            continue
        _walk_cursors(compiled, state, lane_pc, counters, [sub],
                      [entry_pc], block["path"], emit_index=False)


def _walk_cursors(compiled, state: dict, pc: int, counters, tasks, pcs,
                  prefix, emit_index: bool = True) -> None:
    """Write the cursor keys of ``pc`` within the task list ``tasks``, whose
    subtasks start at ``pcs``, under the runtime-label prefix ``prefix``.
    ``emit_index=False`` skips the first level's own index (a parallel
    lane's subtask has none)."""
    named_tasks = compiled.program.get("named_tasks", {})
    code = compiled.code
    # a pc on OP_FOR_NEXT is an iteration done: the host's counter + 1,
    # with no cursor in the body
    at_for_next = pc < len(code) and int(code[pc][0]) == isa.OP_FOR_NEXT
    while True:
        j = 0
        for idx, start in enumerate(pcs, start=1):
            if start <= pc:
                j = idx
        j = max(j, 1)
        if int(code[min(pc, len(code) - 1)][0]) == isa.OP_HALT and \
                prefix is None and emit_index:
            state["order_index"] = len(tasks) + 1
            return
        if emit_index:
            key = "order_index" if prefix is None else \
                f"order_index/{prefix}"
            state[key] = j
        emit_index = True
        if j > len(tasks):
            return
        t = tasks[j - 1]
        path = _label(t) if prefix is None else f"{prefix}/{_label(t)}"
        t, path = _through_run_task(named_tasks, t, path)
        cmd = t.get("cmd")
        if cmd not in ("serial", "for") or \
                path not in compiled.block_task_pcs:
            return
        body = compiled.block_task_pcs[path]
        if cmd == "for":
            loop_id = compiled.block_loop_id.get(path)
            c = int(counters[loop_id]) if loop_id is not None and \
                loop_id < len(counters) else 0
            if pc == pcs[j - 1]:   # at the head
                if c > 0:
                    state[f"order_index/{path}/counter"] = c
                return
            if at_for_next:
                state[f"order_index/{path}/counter"] = c + 1
                return
            state[f"order_index/{path}/counter"] = max(c, 1)
        if not (body and pc >= body[0]):
            return
        tasks, pcs, prefix = t["tasks"], body, path


def pc_of_state(compiled, state: dict, counters) -> tuple:
    """Resolve a state's cursor chain to (pc, unconsumed cursor keys, par),
    the inverse of ``emit_cursors``; the for-counters land in
    ``counters``. ``par`` is None, or for a state saved inside a parallel
    block with lane cursors, ``{mode, join_pc, k, tpc}``: the lane set to
    re-seed (the host re-runs the block, each lane resuming at its cursor
    or restarting)."""
    cursors = {k for k in state if k.startswith("order_index/")}
    consumed: set = set()
    pc, par = _resolve_chain(
        compiled, state, counters, consumed, compiled.program["order"],
        compiled.block_task_pcs.get("", []),
        int(state.get("order_index", 1)), None)
    return pc, cursors - consumed, par


def _resolve_chain(compiled, state: dict, counters, consumed: set, tasks,
                   pcs, k: int, prefix) -> tuple:
    """Walk one cursor chain from index ``k`` of ``tasks`` to its pc: (pc,
    par)."""
    named_tasks = compiled.program.get("named_tasks", {})
    while True:
        if k > len(tasks) and prefix is None:
            return compiled.n_instr - 1, None   # the HALT
        if not 1 <= k <= len(tasks):
            raise ValueError(f"cursor {k} out of range for block "
                             f"{prefix!r}")
        t = tasks[k - 1]
        pc = pcs[k - 1]
        path = _label(t) if prefix is None else f"{prefix}/{_label(t)}"
        t, path = _through_run_task(named_tasks, t, path)
        cmd = t.get("cmd")
        if cmd == "for":
            ckey = f"order_index/{path}/counter"
            if ckey in state:
                consumed.add(ckey)
                loop_id = compiled.block_loop_id.get(path)
                if loop_id is not None and loop_id < len(counters):
                    counters[loop_id] = int(state[ckey])
        if cmd in ("serial", "for"):
            key = f"order_index/{path}"
            if key not in state:
                return pc, None
            consumed.add(key)
            tasks, pcs = t["tasks"], compiled.block_task_pcs[path]
            k, prefix = int(state[key]), path
            continue
        if cmd in ("parallel_wait", "parallel_race"):
            hit = next(((jpc, bl) for jpc, bl in compiled.par_blocks.items()
                        if bl["path"] == path), None)
            lane_keys = [c for c in state
                         if c.startswith(f"order_index/{path}/")]
            if hit is None or not lane_keys:
                return pc, None   # a fresh entry: OP_PAR_BEGIN spawns lanes
            join_pc, block = hit
            tpcs = [int(_resolve_chain(compiled, state, counters, consumed,
                                       [sub], [entry_pc], 1, path)[0])
                    for _lane, entry_pc, sub in block["lanes"]]
            return pc, {"mode": block["mode"], "join_pc": join_pc,
                        "k": len(block["lanes"]), "tpc": tpcs}
        return pc, None
