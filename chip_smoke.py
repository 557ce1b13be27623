#!/usr/bin/env python3
"""Drive the PyTorch port (``interpolation_engine_tpu_torch``) on one CUDA
card and check it.

    python3 chip_smoke.py [--seed N]   # phases 1-22 and the result lines
    python3 chip_smoke.py --turn TREE  # phases 5, 11 and 22's launches,
                                       # phase 13, the chat filter's and
                                       # M and W's times with TREE's
                                       # package

Phases, each of which raises on any failure (the script then exits non-zero
and prints no result):

1. kernel against plain version: for the bench's spine, interp, ring,
   adventure and race-io programs and a set of scalar, list and
   parallel-lane test programs, at 8,192 instances, the CUDA step kernel and
   ``turbo_step_reference`` run the same launches on the card and must leave
   bit-identical regs, sbuf, out and meta after every launch; then the same
   at the widths of promoted siblings: adventure at 2048 bytes, and rows of
   a sibling as promotion builds them at 768 and 2048; then the attributes
   of the step kernel's two instances, one thread a row and a warp a row
   (registers, local, static and dynamic shared bytes);
2. the spine at the bench's size: 131,072 instances,
   ``TurboEngine.run_async`` to the end through the kernel; every instance
   DONE with the host engine's output; tasks/s of kernel and plain version
   over the same launches, and the kernel's bound;
3. the ring: the bench's ring program with every instance parking three
   times on a canned user_input, at the bench's 131,072 instances through
   the ring's fast park path (no park through the exact ``_service``), then
   at 16,384 with the fast path off (the exact ring, every park through
   ``_service``); every instance's output and inserts equal to the host
   engine's, the exact run equal to the fast one instance for instance and
   in steps per instance, and both ring wall times;
4. the CLI: ``--engine device --batch 256`` prints what the port's host CLI
   (``python -m interpolation_engine_tpu_torch.cli PROG``) prints, for the
   spine and for the adventure program;
5. the main path, the bench's default workload at its widths: the adventure
   program (lists, a parallel race per turn) at 131,072 instances; kernel
   and plain version bit-identical over the first two launches, with both
   times; the kernel's ms per launch at K = 1, 8, 32 and 64, the regroup
   of the rows by pc alone (on this lockstep batch, its order the
   identity) against those launches, the staging alone (every instance at
   a pc past the program), and a batch of DONE instances (the skip path)
   beside a copy of the batch and the bound of its bytes, with the step
   kernel's attributes; then ``run_async`` to the end at 40 turns
   through the kernel,
   every instance DONE with the host engine's output and inserts, with the
   steps' share of the wall time, each launch's regroup equal to its plain
   version (``regroup_reference``) and counted;
6. race-io: every instance's race parks its input lane once per turn, 3
   turns, answered "cgo"; at the bench's 131,072 instances through the fast
   park path (every park a fast park, none through the lane servicing
   ``_service_lanes``), then at 16,384 with the fast path off (every park
   through the LaneRing); every instance DONE with the host engine's output
   and inserts and 47 steps, the two runs equal instance for instance, and
   both ring wall times;
7. the brace-scan kernel against its plain version: 1,048,576 seeded random
   rows over the bytes ``ab{}\\ `` at MS 96 and 512, every length from 0 to
   MS, and curated edge rows, then rows of MS 130 at bases 2 and 1 bytes
   past a 16-byte boundary (``bufs[1:]`` and a copy one byte in); all
   bit-identical; the kernel's tile (rows and shared bytes a block, blocks
   an SM); then kernel and plain version timed queued at the bench's
   131,072 x 96, warm (one input, in the L2 cache as on the main path) and
   cold (eight copies cycled), at 1,048,576 x 96 and at 1,048,576 x 512,
   each beside its bound; and its parts at 131,072 x 96 cold: every length
   0 (the copy without the scan) and rows of no bytes (the launch, the
   lengths and the results);
8. the general engine at the bench's width (its second path): the
   adventure program, the bench's general VMConfig, 131,072 instances; two
   launches with every brace-scan, math-evaluator (M) and wildcard (W) call
   held against its plain version on the same inputs (``CheckedMW``); then
   the bench's measurement (one warm launch, recorded, then 8 launches x
   8 steps, no ring) with tasks/s, the brace scan's share of the wall time,
   and M and W's launches in the warm launch (their plain versions ran
   none);
9. the general engine to DONE through the ring: the adventure program at 40
   turns, 4,096 instances (cut from 131,072 because every instance parks
   about 13 times, each a per-row host service); every instance DONE with
   the host engine's output and inserts; ring_stats printed;
10. the CLI on programs the turbo planner rejects: ``--engine device
   --batch 4`` prints what the port's host CLI prints, through the general
   engine and the brace-scan kernel, and so does ``--batch 1``, through
   the interactive ``DeviceProgramRun``;
11. the turbo engine over a mesh (every card when there are two or more,
   else four shards on ``cuda:0``): adventure at 131,072 instances, the
   sharded step bit-identical to the unsharded step and to its plain
   version on the same shards over two launches, with ms per step of each;
   then ``run_async`` through the sharded engine to DONE at 40 turns, and
   race-io at 3 turns, 4,096 instances (cut from 16,384 to keep the script
   short), through the fast park path and then with it off (every park
   gathered from its shard and serviced through ``_service_lanes``), every
   instance equal to the host with 47 steps and the two runs equal;
12. the bench's race-io shape: two sibling engines (``make_shard_engines``,
   ``assign_shard_ids``, ``run_pipelined``) on one card, 16,384 instances,
   3 turns, through the fast park path and then with it off (every park
   through the shared LaneRing under its global id); every instance equal
   to the host, the two runs equal, the summed steps equal to phase 6's
   exact run at 16,384, and the ring wall times beside it;
13. promotion: race-io at the bench's width-512 shape (width 512, elements
   of 128 bytes, output 512), 16,384 instances, where one instance in 16
   answers 1,000 bytes at turn 1: the fast path promotes those instances
   mid-run into one sibling batch of width 2048 (T = 5, a warp a row),
   whose first kernel launches are held bit for bit against the plain
   version; every instance equal to the host with 47 steps; the sibling's
   tile and its ms per launch (queued), beside the plain version's and its
   bound;
14. the general engine's 11 opcodes past its first 19 (``unescape``,
   ``goto_map`` with template keys, ``math``, the list ops, ``replace_map``,
   ``delete``, ``delete_except``, ``random_choice``): the test program
   ``GENERAL_OPS`` on the bench's general VMConfig at 131,072 instances,
   every brace-scan, M and W call of the first two launches held against
   its plain version, then ``run`` to DONE with every instance equal to the
   host (its random_choice given the device's pick, the JAX LCG from rng =
   row + 1); steps, launches, brace-scan, M and W launches (none of the
   plain versions), wall time and tasks/s,
   ``ring_stats``, and the torch calls of one step of each handler;
15. escapes: race-io at phase 13's width-512 shape, 16,384 instances,
   where one instance in 16 answers 3,000 bytes at turn 1, wider than the
   2,048-byte sibling: those 1,024 instances escape to one general-engine
   batch (its lane IO through the shared LaneRing), every instance equal
   to the host; then the same from the mesh engine (phase 11's mesh) at
   4,096 instances; the escape runner's ``ring_stats``; then a program of
   151 byte rows at that width (``torch_programs.many_rows_program``),
   whose 2048-wide sibling does not fit a block's shared memory: no sibling,
   the 256 of 4,096 instances that answer 600 bytes escape, every instance
   equal to the host;
16. resume on the turbo engine: bench.py's divergent batch (the adventure
   at 40 turns, phase 5's config, 131,072 instances from 8 states at
   spread order indexes) through ``load_batch`` (U = 8, its seconds), the
   first launch held against the plain version, run to DONE with every
   instance equal to the host resumed from its class's state, and tasks/s;
   bench.py's ring batch (one instance in ten at ``sel: 'park'``, exit key
   '3') through ``load_batch`` and the fast park path, equal to the host;
   then a round trip: the adventure at 131,072 from the 8 divergent
   states with turns spread 24-39, ``export_state`` of 1,024 rows after
   1, 2 and 3 launches (some inside the parallel block; ms a row; at
   least 128 distinct states and more cursor chains than the 8 starts),
   ``load_batch`` of those states into a fresh engine, run to DONE, each
   row equal to the host resumed from its state; in the three runs every
   regroup equal to its plain version, some of them not the identity (the
   round trip's 1,024 rows, under one wave of blocks, regroup none); the
   regroup alone on the divergent batch, queued, beside its plain version
   and its bound;
17. resume on the general engine: 256 of phase 16's exported states
   through ``DeviceRunner.load_state`` at the bench's general VMConfig,
   the first launch's brace scans held against the plain version, run to
   DONE equal to the host; then ``DeviceProgramRun`` with a scripted
   backend: Save State at the second input and Quit (the spliced file
   parses back to the same ``save_states``), and a fresh run that loads
   slot 1 and prints what the host CLI prints;
18. the general engine over a mesh (phase 11's): the adventure at the
   bench's general VMConfig, 131,072 instances, 2 launches x 8 steps,
   every VMBatch field bit-identical to one device, the brace scan on
   every device of the mesh, ms per step of each; then a parallel_wait
   program at 4,096 instances, each answering its own inputs, to DONE over
   the mesh, field for field the unsharded run, outputs the host's;
19. the chat filter: (a) 16,384 chat-shaped streams (``torch_chat.
   chat_stream``) of 512-8,192 bytes drawn from ``--seed``, padded to 8,192,
   one in 2,048 opening 20 spans: the chat-filter kernel equal to its plain
   version on every field of every stream, enumerating and not; 64 sampled
   streams equal to the host filters fed a character a call, the 20-span
   streams through ``filter_chat_host`` to the host oracle; the kernel's
   time queued and the plain version's beside its bound, and its time on
   inputs that leave out one part of its work at a time; the kernel's
   attributes; the kernel equal to its plain version on one stream in
   ``host_row``'s (1, L) row, 8 KB at L = 16,384 and about 100 KB of 20
   spans at L = 131,072, and its time queued on the 8 KB row; (b) the chat
   service's per-stream call (``filter_chat_host``: upload, launch,
   download) on one 8 KB stream beside the host's incremental filters; (c)
   the chat programs of ``torch_programs`` (a turn loop, and a
   ``parallel_wait`` block) at 256 instances through the turbo engine
   against one local fake chat server, one character an SSE event, with
   ``IE_TPU_DEVICE_FILTERS=1`` and without: every instance equal to the
   host, one filter launch a chat call;
20. the port's bench (``interpolation_engine_tpu_torch/bench.py``) at
   131,072 instances, in process: spine, divergent (8 states), interp, ring
   (one in ten parking), race-io (two shard engines), the adventure at
   width 512 (its tile printed) and the general engine; then the default
   run (the adventure) as
   ``python -m interpolation_engine_tpu_torch.bench``, its executed steps
   equal to the plain step version's over the same launches from the same
   batch; each JSON line with its four keys, a positive value and a metric
   naming the card, the engine and the workload, printed as ``bench:
   {...}``; the in-process runs' launches of the step kernel, the brace
   scan, M and W join their counts below (M and W's also from phases 15, 17
   and 18's general paths);
21. M and W alone at the bench's general VMConfig (MS 96, max_stars 2),
   their registers, stack and shared bytes a block, then at 131,072 rows
   (the bench's batch) and at 4,096 (phases 9 and 14's), each made from
   ``--seed``: (a) the math evaluator on flat expressions (ints with
   near-wrap values, the seven operators, unary signs, spaces, faults) and
   in its enumeration mode on comma lists with a min or max per row; (b)
   the wildcard matcher on per-row patterns of 0-3 stars and segments up
   to 33 bytes (some unsupported) against subjects up to 96 bytes, one in
   four ending in a newline, then on one shared pattern; each kernel equal
   to its plain version on every field of every row, then timed queued
   beside its bound (the plain version at 131,072);
22. the ``prompt-chain`` cell's shape (portbench's configuration and
   traffic): 131,072 rows resumed from the traffic's states drawn from
   ``--seed``, 2048-byte slots, T = 3, each row stepped by a warp; the
   first two launches of 32 steps held bit for bit against the plain
   version, then the launch timed queued at K = 1 and 32 beside its bound,
   and the staging alone beside a copy of the batch and the bound of its
   bytes, with the step kernel's attributes.

Every phase that launches the step kernel prints its tile (``launch_plan``:
T instances a block, the shared bytes). A kernel's time is taken with the
card asleep while the host queues the launches, so that it is the card's
time alone. The host oracle is the port's own copy of the host runtime.
A phase counts its main path's launches from the port's counters
(``counts``: ``kernel.<name>`` a kernel's launches, ``plain.<name>`` its
plain version's calls, ``turbo.warp_row_launches`` the step kernel's
launches that stepped a row with a warp), recorded around that path only,
never around a timing loop; a main path's own wall time is taken while
recording, one host sync a step launch more than a run unrecorded.
The last two lines of standard output are one JSON object naming each kernel (the
regroup's three kernels, ``csrc/regroup.cu``, as one entry) with its
launches on its main path (for the step kernel, those of phases 5, 13, 16
and 20, and apart, in ``warp_launches``, those of them that stepped a row
with a warp; phase 22's launches are checks and timings), its largest
deviation from the plain version,
its time, the plain version's, the least time the card could take for the
same work (``bound_ms``: the bytes it must move over 3.35 TB/s, or its
operations over 67 TFLOP/s, whichever is larger; over several cards, the
busiest card's share) and the time of a PyTorch
call computing the same (none exists for these kernels but the regroup,
whose plain version is ``torch.sort``), then ``{"ok":
true, "device": ...}``. Needs one CUDA card; imports nothing of JAX and
nothing of the JAX package.
"""

import asyncio
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "interpolation_engine_tpu_torch/csrc/turbo_step.cu"
KERNEL_REPLACES = "interpolation_engine_tpu/vm/turbo.py:1879"
SCAN_SRC = "interpolation_engine_tpu_torch/csrc/brace_scan.cu"
SCAN_REPLACES = "interpolation_engine_tpu/ops/pallas_scan.py:87"
SHARDED_REPLACES = "interpolation_engine_tpu/vm/turbo.py:1991"
FILTER_SRC = "interpolation_engine_tpu_torch/csrc/chat_filter.cu"
FILTER_REPLACES = "interpolation_engine_tpu/ops/filter_kernel.py:155"
MATH_SRC = "interpolation_engine_tpu_torch/csrc/math_eval.cu"
MATH_REPLACES = "interpolation_engine_tpu/ops/math_kernel.py:92"
MATCH_SRC = "interpolation_engine_tpu_torch/csrc/wildcard_match.cu"
MATCH_REPLACES = "interpolation_engine_tpu/ops/match_kernel.py:188"
REGROUP_SRC = "interpolation_engine_tpu_torch/csrc/regroup.cu"
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
OPS_PER_S = 67e12             # float32 outside the tensor cores, the same
QUEUE_CYCLES = 20_000_000     # the card's sleep while launches queue: 11 ms


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def compile_src(src: str):
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader, validator)
    program = json5.loads(loader.add_line_numbers(src))
    validator.validate_program(program)
    return compile_program(program)


def run_host(src: str, io, tmp: str) -> dict:
    """The exact host engine's final state for one instance."""
    from interpolation_engine_tpu_torch._shared import runtime
    path = os.path.join(tmp, "prog.json5")
    with open(path, "w") as f:
        f.write(src)
    with contextlib.redirect_stdout(sys.stderr):
        return asyncio.run(runtime.async_main(path, [], io))


_CANNED = {}


def canned_io(answer: str = "ok"):
    """An IO manager whose backend answers every user_input with ``answer``
    at once (``sync_io``, as the bench's canned backends)."""
    from interpolation_engine_tpu_torch._shared import io_manager
    cls = _CANNED.get(answer)
    if cls is None:
        class Canned(io_manager.BufferBackend):
            sync_io = True

            def user_input_sync(self, prompt, default=""):
                return answer

            async def user_input(self, prompt, default=""):
                return answer
        cls = _CANNED[answer] = Canned
    return io_manager.IOManager(cls())


@contextlib.contextmanager
def fast_ring(on: bool):
    """``IE_TPU_FAST_RING`` for the engines made inside (each reads it when
    it is made): off sends every park the exact way."""
    old = os.environ.get("IE_TPU_FAST_RING")
    os.environ["IE_TPU_FAST_RING"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["IE_TPU_FAST_RING"]
        else:
            os.environ["IE_TPU_FAST_RING"] = old


def count_services(engines, counts: dict = None) -> dict:
    """Count the parked rows the exact path services (``_service``) and,
    of those, the ones the lane servicing takes (``_service_lanes``), over
    the engines given."""
    counts = counts or {"_service": 0, "_service_lanes": 0}
    for eng in engines:
        for name in ("_service", "_service_lanes"):
            method = getattr(eng, name)

            async def counted(*args, _method=method, _name=name):
                counts[_name] += 1
                return await _method(*args)
            setattr(eng, name, counted)
    return counts


@contextlib.contextmanager
def counts():
    """Yields a ``Counter`` that holds, once the block ends, the port's
    counters over the block (``EVENTS``): ``kernel.<name>`` for a hand
    kernel's launches, ``plain.<name>`` for its plain version's calls,
    ``turbo.warp_row_launches`` and the rest. Records the port's spans and
    counters over the block, which adds a host sync to each step launch:
    wrap a main path, never a timing loop."""
    from interpolation_engine_tpu_torch.core.events import EVENTS
    got = Counter()
    with EVENTS.recording() as rec:
        yield got
    got.update(rec.counters)


def on_main_path(phase: str, got, *kernels: str, plain: int = 0) -> None:
    """Raises unless each of ``kernels`` launched in ``got`` (``counts``)
    and the plain versions ran ``plain`` times in all (a check's calls)."""
    idle = [k for k in kernels if got[f"kernel.{k}"] <= 0]
    ran = sum(v for k, v in got.items() if k.startswith("plain."))
    if idle or ran != plain:
        raise AssertionError(f"{phase}: on the main path {idle} launched "
                             f"no kernel and the plain versions ran {ran} "
                             f"times, not {plain}: {dict(got)}")


def ring_run(eng, n: int):
    """``eng.run`` on n fresh instances to the end, timed to a synchronise
    of every card, with ``count_services``. Returns (final batch, seconds,
    exact services, lane services)."""
    counts = count_services([eng])
    batch = eng.make_batch(n)
    sync_all()
    t0 = time.perf_counter()
    final = eng.run(batch)
    sync_all()
    return (final, time.perf_counter() - t0, counts["_service"],
            counts["_service_lanes"])


def summary(r) -> tuple:
    return (r.output, r.inserts, r.status, r.steps)


def fast_split(eng) -> str:
    rs = eng.ring_stats
    return (f"{rs['fast_parks']} of {rs['parks']} parks on the fast path, "
            f"ring_ms {rs['ring_ms']:.1f}")


def clone(batch):
    return type(batch)(*(t.clone() for t in batch))


def max_abs_diff(a, b) -> int:
    """The largest difference of two batches' fields, 64M elements at a
    time (a 2048-byte batch's bytes do not fit the card as int64 at
    once)."""
    chunk = 1 << 26
    return max((int((x.long() - y.long()).abs().max())
                for xs, ys in zip(a, b) if xs.numel()
                for x, y in zip(xs.flatten().split(chunk),
                                ys.flatten().split(chunk))), default=0)


def spread_slot(engine, batch, key: str, hi: int, gen) -> None:
    """Start each instance at its own value of int slot ``key`` so lanes
    leave their loops at different pcs and rounds."""
    import torch
    col = engine.cols.sint(engine.plan.slot_of[key])
    batch.regs[:, col] = torch.randint(
        0, hi, (batch.regs.shape[0],), generator=gen,
        dtype=torch.int32).to(batch.regs.device)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int) -> dict:
    """The least time the card could take: the bytes over the memory rate
    or the operations over the peak rate, whichever is larger."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def step_bound(tables, batch, steps: int) -> dict:
    """A step launch reads and writes the batch once and reads the tables
    once; each VM step it executes is at least one operation."""
    return bound(2 * nbytes(batch) + nbytes((tables.flat, tables.lits)),
                 steps)


def plan_lanes(plan) -> int:
    """The lanes that step a row under ``plan``: 1 in a tree from before
    the warp path (``--turn``), whose plan names no lane group."""
    return getattr(plan, "lanes", 1)


def tile_line(tables, batch, tile: int) -> str:
    """The step kernel's tile for this batch (``launch_plan``, the plan the
    wrapper launches with)."""
    from interpolation_engine_tpu_torch.ops.turbo_step import launch_plan
    plan = launch_plan(tables, batch, tile)
    where = "shared" if plan.lits_off >= 0 else "device"
    group = "a warp" if plan_lanes(plan) > 1 else "one thread"
    return (f"tile T={plan.tile} instances, {group} a row, {plan.smem} "
            f"bytes of dynamic shared memory a block, literals in {where} "
            f"memory")


def attributes_line() -> str:
    """Both instances of the step kernel: one thread a row and a warp a
    row."""
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        WARP, kernel_attributes)
    parts = []
    for lanes in (1, WARP):
        a = kernel_attributes(0, lanes)
        parts.append(
            f"turbo_step_kernel<{lanes}> attributes: {a['registers']} "
            f"registers, {a['local_bytes']} local bytes per thread, "
            f"{a['static_shared_bytes']} static shared bytes, "
            f"{a['max_dynamic_shared_bytes']} dynamic shared bytes allowed, "
            f"at most {a['max_threads']} threads a block")
    return "; ".join(parts)


def timed_steps(eng) -> list:
    """CUDA events around every step ``eng.run`` launches (the main path's
    kernel launches); returns the list the pairs go into."""
    import torch
    events = []
    make = eng.step_fn

    def step_fn(n):
        step = make(n)

        def timed_step(batch):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(batch)
            ev[1].record()
            events.append(ev)
            return out
        return timed_step
    eng.step_fn = step_fn
    return events


def mesh_step_bound(tables, batch, row_steps, mesh, offsets,
                    launches: int) -> dict:
    """The sharded step's bound: its devices run at once, so it is the
    busiest device's, from the rows of its shards (read and written once,
    the tables read once on each device) and the VM steps those rows ran
    per launch (``row_steps`` holds each row's steps over ``launches``)."""
    per_row = nbytes(batch) / batch.regs.shape[0]
    spans = {}
    for s, dev in enumerate(mesh):
        spans.setdefault(dev, []).append((offsets[s], offsets[s + 1]))
    table_bytes = nbytes((tables.flat, tables.lits))
    return max((bound(2 * per_row * sum(b - a for a, b in dev_spans)
                      + table_bytes,
                      sum(int(row_steps[a:b].sum()) for a, b in dev_spans)
                      // launches)
                for dev_spans in spans.values()),
               key=lambda d: d["bound_ms"])


def phase1(progs: dict, n: int = 8192, launches: int = 4) -> int:
    """Kernel == plain version after every launch; returns the largest
    deviation seen (0 when bit-identical)."""
    from interpolation_engine_tpu_torch import bench
    import torch
    import torch_programs as tp
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        TurboConfig, TurboEngine)
    worst = 0
    gen = torch.Generator().manual_seed(SEED)
    narrow = TurboConfig(width=128, out_width=192, k_steps=16)
    cases = [(name, src, spread, narrow, None)
             for name, (src, spread) in progs.items()]
    # the widths of promoted siblings: the bench's width-512 cell 4x, and a
    # sibling's rows as promotion builds them, values past the parent's slot
    wide = TurboConfig(width=2048, out_width=2048, k_steps=16, list_cap=12,
                       elem_width=512)
    cases += [("adventure_w2048", bench.adventure_program(), ("turn", 600),
               wide, None)]
    for width, size in ((768, 600), (2048, 1800)):
        cases.append((f"promoted_w{width}", tp.PROMOTED_PRINT, None,
                      TurboConfig(width=width, out_width=width, k_steps=16),
                      lambda eng, size=size: tp.promoted_batch(eng, size, n)))
    for name, src, spread, tcfg, make in cases:
        eng = TurboEngine(compile_src(src), tcfg, device="cuda")
        b = make(eng) if make else eng.make_batch(n)
        if spread:
            spread_slot(eng, b, spread[0], spread[1], gen)
        kern, ref = clone(b), clone(b)
        for k in range(launches):
            turbo_step(eng.tables, kern, 16)
            turbo_step_reference(eng.tables, ref, 16)
            torch.cuda.synchronize()
            diff = max_abs_diff(kern, ref)
            worst = max(worst, diff)
            if diff:
                raise AssertionError(f"phase 1 {name}: kernel and plain "
                                     f"version differ after launch {k + 1}")
        status = kern.regs[:, 1]
        log(f"phase 1 {name}: {launches} launches x 16 steps at {n} "
            f"instances bit-identical (running {int((status == 0).sum())}, "
            f"done {int((status == 1).sum())}, "
            f"parked {int((status == 2).sum())}); "
            f"{tile_line(eng.tables, b, eng.tcfg.tile)}")
    return worst


def timed(fn, batch, launches: int, queued: bool = False) -> float:
    """Seconds for ``launches`` calls of fn on batch, by CUDA events. With
    ``queued`` the card first sleeps while the host enqueues the calls, so
    the span holds the card's time alone, not the host's time between
    launches (a kernel launch costs the host about 0.2 ms)."""
    import torch
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn(batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def phase2(card: str, tmp: str, n: int = 131_072) -> None:
    from interpolation_engine_tpu_torch import bench
    import torch
    from interpolation_engine_tpu_torch._shared import io_manager
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, TurboConfig, TurboEngine)

    host = run_host(bench.BENCH_PROGRAM,
                    io_manager.IOManager(io_manager.BufferBackend()), tmp)
    want = host["output"]
    assert want.startswith("done acc="), want
    tcfg = TurboConfig(tile=128, width=128, out_width=128, k_steps=64)
    eng = TurboEngine(compile_src(bench.BENCH_PROGRAM), tcfg, device="cuda")
    K = tcfg.k_steps
    b0 = eng.make_batch(n)

    # kernel and plain version over the same launches from the same state
    warm = clone(b0)
    turbo_step(eng.tables, warm, K)
    turbo_step_reference(eng.tables, warm, 1)
    del warm
    L = 2
    kern, ref = clone(b0), clone(b0)
    t_kern = timed(lambda b: turbo_step(eng.tables, b, K), kern, L, True)
    t_ref = timed(lambda b: turbo_step_reference(eng.tables, b, K), ref, L)
    if max_abs_diff(kern, ref):
        raise AssertionError("phase 2: kernel and plain version differ")
    steps = int(kern.regs[:, C_STEPS].long().sum())
    spine_bound = step_bound(eng.tables, b0, steps // L)
    del kern, ref
    log(f"phase 2 spine, first {L} launches x {K} steps at {n} instances "
        f"[{card}]: kernel {steps / t_kern:.1f} tasks/s "
        f"({t_kern / L * 1e3:.3f} ms/launch), plain version "
        f"{steps / t_ref:.1f} tasks/s ({t_ref / L * 1e3:.3f} ms/launch); "
        f"bound {spine_bound['bound_ms']:.4f} ms "
        f"({spine_bound['bound_by']}), the kernel at "
        f"{spine_bound['bound_ms'] / (t_kern / L) / 10:.1f} % of it; "
        f"{tile_line(eng.tables, b0, tcfg.tile)}")

    # the main path: run_async to the end, counted
    torch.cuda.synchronize()
    with counts() as got:
        t0 = time.perf_counter()
        final = eng.run(b0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    on_main_path("phase 2", got, "turbo_step")
    launches = got["kernel.turbo_step"]
    check_all_done("phase 2", eng, final, host)
    total = int(final.regs[:, C_STEPS].long().sum())
    log(f"phase 2 spine main path [{card}]: {n} instances DONE with "
        f"{want!r}, {launches} kernel launches, {total} steps in "
        f"{elapsed:.3f} s = {total / elapsed:.1f} tasks/s end to end")


def phase3(card: str, tmp: str, n: int = 131_072,
           n_exact: int = 16_384) -> None:
    """The ring program through the fast park path at the bench's size,
    then through the exact ring."""
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, TurboConfig, TurboEngine)
    src = bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'") \
        .replace("'1073741824'", "'3'")
    host = run_host(src, canned_io(), tmp)
    want = (host["output"], dict(host["inserts"]))
    runs = {}
    for fast, size in ((True, n), (False, n_exact)):
        with fast_ring(fast):
            eng = TurboEngine(compile_src(src), TurboConfig(
                width=128, out_width=192, k_steps=64), io_factory=lambda i:
                canned_io(), device="cuda")
        final, elapsed, exact, _ = ring_run(eng, size)
        rs = eng.ring_stats
        n_fast = 3 * size if fast else 0
        if rs["parks"] != 3 * size or rs["fast_parks"] != n_fast or \
                exact != 3 * size - n_fast:
            raise AssertionError(f"phase 3: {rs['parks']} parks, "
                                 f"{rs['fast_parks']} fast, {exact} exact; "
                                 f"want {3 * size}, {n_fast}")
        check_all_done("phase 3", eng, final, host)
        res = eng.results(final)
        for i, r in enumerate(res):
            if (r.output, r.inserts) != want:
                raise AssertionError(f"phase 3: instance {i}: {r} != {want}")
        steps = int(final.regs[:, C_STEPS].long().sum())
        runs[fast] = res, steps
        path = "fast park path" if fast else "exact ring (fast path off)"
        log(f"phase 3 ring, {path} [{card}]: {size} instances, "
            f"{rs['parks']} parks in {rs['rounds']} rounds ({fast_split(eng)}"
            f", {exact} through _service), ring wall time {elapsed:.3f} s, "
            f"{steps} steps, all DONE with {want[0]!r}")
    (fast_res, fast_steps), (exact_res, exact_steps) = runs[True], runs[False]
    if [summary(r) for r in exact_res] != \
            [summary(r) for r in fast_res[:n_exact]] or \
            fast_steps * n_exact != exact_steps * n:
        raise AssertionError("phase 3: the exact ring differs from the fast "
                             "park path")
    log(f"phase 3 ring: the exact run equals the fast run instance for "
        f"instance, {exact_steps // n_exact} steps an instance in both")


def phase4(tmp: str) -> None:
    from interpolation_engine_tpu_torch import bench
    for name, src in (("spine", bench.BENCH_PROGRAM),
                      ("adventure", bench.adventure_program(t_max=40))):
        path = os.path.join(tmp, f"{name}.json5")
        with open(path, "w") as f:
            f.write(src)

        def cli(*args):
            return subprocess.run([sys.executable, "-m", *args, path],
                                  cwd=ROOT, capture_output=True, text=True,
                                  check=True, timeout=300).stdout
        port = cli("interpolation_engine_tpu_torch.cli", "--engine",
                   "device", "--batch", "256")
        host = cli("interpolation_engine_tpu_torch.cli")
        if port != host:
            raise AssertionError(f"phase 4 {name}: port CLI {port!r} != "
                                 f"host {host!r}")
        log(f"phase 4 cli {name}: --engine device --batch 256 printed "
            f"{port!r}, as the host CLI")


def check_all_done(name: str, eng, final, host: dict) -> None:
    """Every instance DONE with the host's output (compared on the card)
    and instance 0's decoded output and inserts equal to the host's."""
    import torch
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_OUTLEN, C_STATUS, DONE)
    status = final.regs[:, C_STATUS]
    if not bool((status == DONE).all()):
        raise AssertionError(f"{name}: {int((status != DONE).sum())} "
                             f"instances not DONE")
    data = host["output"].encode()
    expect = torch.tensor(list(data), dtype=torch.uint8,
                          device=final.out.device)
    if not (bool((final.regs[:, C_OUTLEN] == len(data)).all())
            and bool((final.out[:, :len(data)] == expect).all())):
        raise AssertionError(f"{name}: an output differs from the host's")
    r0 = eng.results(final, 1)[0]
    if (r0.output, r0.inserts) != (host["output"], dict(host["inserts"])):
        raise AssertionError(f"{name}: decoded {r0} != host {host}")


def adventure_tcfg():
    """bench.py's adventure config without the TPU-only tile and leaf."""
    from interpolation_engine_tpu_torch.vm.turbo import TurboConfig
    return TurboConfig(width=128, out_width=128, k_steps=64, list_cap=12,
                       elem_width=32)


def adventure_launches(card: str, n: int = 131_072) -> dict:
    """Phase 5's launches on the adventure program at the bench's widths:
    the first two held against the plain version and both timed, then the
    launch by K, the regroup alone, the staging alone beside a copy of the
    batch, and the skip path. Returns the kernel's and plain version's ms
    a launch, its bound and deviation, and the staging's and copy's ms."""
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        launch_plan, regroup, regroups, sm_count, turbo_step,
        turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_PC, C_STATUS, C_STEPS, DONE, TurboEngine)

    tcfg = adventure_tcfg()
    K = tcfg.k_steps
    eng = TurboEngine(compile_src(bench.adventure_program()), tcfg,
                      device="cuda")
    b0 = eng.make_batch(n)
    warm = clone(b0)
    turbo_step(eng.tables, warm, K)
    turbo_step_reference(eng.tables, warm, 1)
    del warm
    L = 2
    kern, ref = clone(b0), clone(b0)
    t_kern = timed(lambda b: turbo_step(eng.tables, b, K), kern, L, True)
    t_ref = timed(lambda b: turbo_step_reference(eng.tables, b, K), ref, L)
    worst = max_abs_diff(kern, ref)
    if worst:
        raise AssertionError("phase 5: kernel and plain version differ")
    steps = int(kern.regs[:, C_STEPS].long().sum())
    launch_bound = step_bound(eng.tables, b0, steps // L)
    log(f"phase 5 adventure, first {L} launches x {K} steps at {n} "
        f"instances [{card}]: kernel {steps / t_kern:.1f} tasks/s "
        f"({t_kern / L * 1e3:.3f} ms/launch), plain version "
        f"{steps / t_ref:.1f} tasks/s ({t_ref / L * 1e3:.3f} ms/launch); "
        f"{tile_line(eng.tables, b0, tcfg.tile)}")
    del kern, ref
    # per-launch against per-step cost: the first L launches at K = 1, 8,
    # 32, 64
    per_k = {k: timed(lambda b, k=k: turbo_step(eng.tables, b, k), clone(b0),
                      L, True) / L * 1e3 for k in (1, 8, 32, 64)}
    log(f"phase 5 adventure ms/launch by K [{card}]: " + ", ".join(
        f"K={k} {ms:.3f}" for k, ms in per_k.items()))
    # the regroup alone on this lockstep batch (its order the identity),
    # against the launches above, which each begin with it
    calls = 100
    group_ms = timed(lambda b: regroup(eng.tables, b.regs), b0, calls,
                     True) / calls * 1e3
    tile = launch_plan(eng.tables, b0, tcfg.tile).tile
    log(f"phase 5 adventure, the regroup alone [{card}]: {group_ms:.4f} "
        f"ms/call ({calls} calls queued), {100 * group_ms / per_k[32]:.2f} "
        f"% of a launch at K=32, {100 * group_ms / per_k[64]:.2f} % at "
        f"K=64; a launch of {n} rows at {tile} a block regroups: "
        f"{regroups(n, tile, sm_count(b0.regs.device))}")
    # the copies alone: every instance RUNNING at a pc past the program,
    # so each tile is staged in and out and steps nothing; and a batch of
    # DONE instances, whose tiles read their status column only
    staged, done = clone(b0), clone(b0)
    staged.regs[:, C_PC] = eng.tables.host.n_instr
    done.regs[:, C_STATUS] = DONE
    S = 10
    t_stage = timed(lambda b: turbo_step(eng.tables, b, K), staged, S, True)
    t_done = timed(lambda b: turbo_step(eng.tables, b, K), done, S, True)
    t_copy = timed(clone, done, S, True)
    stage_bound = step_bound(eng.tables, b0, 0)["bound_ms"]
    log(f"phase 5 adventure, the staging alone [{card}]: "
        f"{t_stage / S * 1e3:.4f} ms/launch; a batch of DONE instances "
        f"{t_done / S * 1e3:.4f} ms/launch; a copy of the batch (clone of "
        f"its tensors, the staging's bytes) {t_copy / S * 1e3:.4f} ms; "
        f"bound {stage_bound:.4f} ms (the batch read and written once, the "
        f"tables read once)")
    log(attributes_line())
    return {"ms": t_kern / L * 1e3, "plain_ms": t_ref / L * 1e3,
            "max_abs_err": worst, "stage_ms": t_stage / S * 1e3,
            "copy_ms": t_copy / S * 1e3, **launch_bound}


def phase5(card: str, tmp: str, n: int = 131_072) -> dict:
    """The main path: the adventure program at the bench's widths."""
    from interpolation_engine_tpu_torch import bench
    import torch
    from interpolation_engine_tpu_torch._shared import io_manager
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        launch_plan, regroups, sm_count)
    from interpolation_engine_tpu_torch.vm.turbo import C_STEPS, TurboEngine

    launched = adventure_launches(card, n)
    tcfg = adventure_tcfg()
    # the main path: run_async to the end at 40 turns, counted
    src = bench.adventure_program(t_max=40)
    host = run_host(src, io_manager.IOManager(io_manager.BufferBackend()),
                    tmp)
    eng = TurboEngine(compile_src(src), tcfg, device="cuda")
    batch = eng.make_batch(n)
    events = timed_steps(eng)
    torch.cuda.synchronize()
    with CheckedRegroup("phase 5") as groups, counts() as got:
        t0 = time.perf_counter()
        final = eng.run(batch)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    kernel_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    on_main_path("phase 5", got, "turbo_step")
    launches = got["kernel.turbo_step"]
    tile = launch_plan(eng.tables, batch, tcfg.tile).tile
    if got["kernel.regroup"] != groups.compared or groups.compared != (
            launches if regroups(n, tile, sm_count(batch.regs.device))
            else 0):
        raise AssertionError(
            f"phase 5: {got['kernel.regroup']} regroups, {groups.compared} "
            f"compared, over {launches} launches")
    check_all_done("phase 5", eng, final, host)
    total = int(final.regs[:, C_STEPS].long().sum())
    log(f"phase 5 adventure main path [{card}]: {n} instances DONE with "
        f"the host's {len(host['output'].encode())}-byte output, {launches} "
        f"kernel launches, {eng.ring_stats['parks']} parks, {total} steps "
        f"in {elapsed:.3f} s = {total / elapsed:.1f} tasks/s end to end; "
        f"the steps {kernel_s * 1e3:.3f} ms of it ({kernel_s / elapsed:.4f});"
        f" {groups.compared} regroups, each equal to its plain version "
        f"({groups.moved} not the identity)")
    return {"counts": got, "regroup_max_abs_err": groups.worst, **launched}


def phase6(card: str, tmp: str, n: int = 131_072,
           n_exact: int = 16_384) -> dict:
    """race-io: one lane park per instance per turn, through the fast park
    path at the bench's size, then through the LaneRing."""
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, DONE, TurboConfig, TurboEngine)
    src = bench.race_io_program(t_max=3)
    host = run_host(src, canned_io("cgo"), tmp)
    want = (host["output"], dict(host["inserts"]), DONE, 47)
    runs = {}
    for fast, size in ((True, n), (False, n_exact)):
        with fast_ring(fast):
            eng = TurboEngine(compile_src(src), TurboConfig(
                width=128, out_width=128, k_steps=16, list_cap=12,
                elem_width=32), io_factory=lambda i: canned_io("cgo"),
                device="cuda")
        final, elapsed, exact, lanes = ring_run(eng, size)
        rs = eng.ring_stats
        n_fast = 3 * size if fast else 0
        if rs["parks"] != 3 * size or rs["fast_parks"] != n_fast or \
                lanes != exact or lanes != 3 * size - n_fast:
            raise AssertionError(
                f"phase 6: {rs['parks']} parks, {rs['fast_parks']} fast, "
                f"{lanes} through the lane servicing; want {3 * size} parks, "
                f"{n_fast} fast")
        check_all_done("phase 6", eng, final, host)
        res = eng.results(final)
        for i, r in enumerate(res):
            if summary(r) != want:
                raise AssertionError(f"phase 6: instance {i}: {r} != {want}")
        steps = int(final.regs[:, C_STEPS].long().sum())
        runs[fast] = {"seconds": elapsed, "steps": steps, "n": size}
        path = "fast park path" if fast else "exact ring (fast path off)"
        log(f"phase 6 race-io, {path} [{card}]: {size} instances, "
            f"{rs['parks']} lane parks in {rs['rounds']} rounds "
            f"({fast_split(eng)}, {lanes} through _service_lanes), ring "
            f"wall time {elapsed:.3f} s, {steps} steps, all DONE with "
            f"{want[0]!r} and 47 steps; "
            f"{tile_line(eng.tables, final, eng.tcfg.tile)}")
    log(f"phase 6 race-io: fast park path {runs[True]['seconds']:.3f} s at "
        f"{n} instances against the exact ring's "
        f"{runs[False]['seconds']:.3f} s at {n_exact}")
    return runs[False]


SCAN_EDGES = ["", "{", "}", "{a}", "\\{", "\\}", "a\\{", "{a\\}", "\\\\{",
              "{}{", "}{", "{{a}}", "x{a}y\\{b\\}", "{a}" + "b" * 200 + "}",
              "\\" * 40 + "{"]


def scan_rows(n: int, ms: int, gen):
    """n seeded random rows over ``ab{}\\ `` with every length from 0 to
    ms, then the curated edge rows (with braces past their length)."""
    import torch
    alphabet = torch.tensor(list(b"ab{}\\ "), dtype=torch.uint8,
                            device="cuda")
    bufs = alphabet[torch.randint(0, 6, (n, ms), generator=gen,
                                  device="cuda")]
    lengths = (torch.arange(n, device="cuda") % (ms + 1)).to(torch.int32)
    edge = torch.zeros((2 * len(SCAN_EDGES), ms), dtype=torch.uint8)
    edge_len = []
    for i, text in enumerate(SCAN_EDGES):
        data = text.encode()[:ms]
        for j, extra in enumerate((b"", b"}{}")):
            row = (data + extra)[:ms]
            edge[2 * i + j, :len(row)] = torch.tensor(list(row),
                                                      dtype=torch.uint8)
            edge_len.append(len(data))
    bufs = torch.cat([bufs, edge.cuda()])
    lengths = torch.cat([lengths, torch.tensor(edge_len, dtype=torch.int32,
                                               device="cuda")])
    return bufs.contiguous(), lengths.contiguous()


def scan_bound(n: int, ms: int) -> dict:
    """A scan call reads each row's bytes and length once and writes four
    int32s a row; it compares each byte at least once."""
    return bound(n * ms + 4 * n + 16 * n, n * ms)


def time_scan(fn, inputs, calls: int) -> float:
    """ms per call of fn over ``inputs`` taken in turn, queued (``timed``),
    after one untimed pass over all of them. With one input it stays in
    the L2 cache (warm); with copies that together outgrow the 50 MB L2,
    each call finds its input in device memory (cold)."""
    import itertools
    import torch
    for bufs, lengths in inputs:
        fn(bufs, lengths)
    torch.cuda.synchronize()
    turns = itertools.cycle(inputs)
    return timed(lambda t: fn(*next(t)), turns, calls, True) / calls * 1e3


def scan_times(card: str) -> dict:
    """Kernel and plain version timed queued at 131,072 x 96 warm and cold,
    1,048,576 x 96 and 1,048,576 x 512, each printed beside its bound;
    returns the cold 131,072 x 96 times with their bound."""
    import torch
    from interpolation_engine_tpu_torch.ops.brace_scan import (
        brace_scan, brace_scan_reference)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main = scan_rows(131_072 - 2 * len(SCAN_EDGES), 96, gen)
    cases = [("131,072 x 96 warm (one input, in L2 as on the main path)",
              [main], 24, 8),
             ("131,072 x 96 cold (8 copies cycled, 122 MB)",
              [main] + [tuple(t.clone() for t in main) for _ in range(7)],
              24, 8)]
    for ms in (96, 512):
        cases.append((f"1,048,576 x {ms}",
                      [scan_rows((1 << 20) - 2 * len(SCAN_EDGES), ms, gen)],
                      12 if ms == 96 else 6, 3))
    times = {}
    for label, inputs, k_calls, p_calls in cases:
        n, ms = inputs[0][0].shape
        k = time_scan(brace_scan, inputs, k_calls)
        p = time_scan(brace_scan_reference, inputs, p_calls)
        b = scan_bound(n, ms)
        times[label] = (k, p, b)
        log(f"phase 7 brace scan {label} [{card}]: kernel {k:.5f} ms/call, "
            f"plain version {p:.4f} ms/call (queued); bound "
            f"{b['bound_ms']:.5f} ms ({b['bound_by']}), the kernel at "
            f"{b['bound_ms'] / k * 100:.1f} % of it")
        del inputs
    k, p, b = times[cases[1][0]]
    if k < b["bound_ms"]:
        raise AssertionError(f"phase 7: the cold time {k:.5f} ms is under "
                             f"the bound {b['bound_ms']:.5f}: not cold")
    return {"ms": k, "plain_ms": p, **b}


def phase7(card: str) -> dict:
    """The brace-scan kernel == its plain version, bit for bit, then its
    tile and its queued times."""
    import torch
    from interpolation_engine_tpu_torch.ops.brace_scan import (
        brace_scan, brace_scan_reference, kernel_plan)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def held(bufs, lengths, what):
        got = brace_scan(bufs, lengths)
        want = brace_scan_reference(bufs, lengths)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).any(dim=1).sum())
            raise AssertionError(f"phase 7: kernel and plain version differ "
                                 f"on {bad} rows {what}")

    for ms in (96, 512):
        bufs, lengths = scan_rows(1 << 20, ms, gen)
        held(bufs, lengths, f"at MS {ms}")
        log(f"phase 7 brace scan MS {ms} [{card}]: {bufs.shape[0]} rows "
            f"bit-identical")
        del bufs, lengths
    # rows whose base is not 16-byte aligned: bufs[1:] (130 bytes on) and a
    # copy one byte into a buffer
    bufs, lengths = scan_rows(65_536, 130, gen)
    flat = torch.empty(bufs.numel() + 1, dtype=torch.uint8, device="cuda")
    shifted = flat[1:].view(bufs.shape)
    shifted.copy_(bufs)
    for view, ln in ((bufs[1:], lengths[1:].contiguous()),
                     (shifted, lengths)):
        held(view, ln, f"at MS 130, base {view.data_ptr() % 16} bytes past "
             f"a 16-byte boundary")
    log(f"phase 7 brace scan MS 130 [{card}]: {bufs.shape[0]} rows at bases "
        f"{bufs[1:].data_ptr() % 16} and {shifted.data_ptr() % 16} bytes "
        f"past a 16-byte boundary bit-identical")
    del bufs, lengths, flat, shifted
    for ms in (96, 130, 512):
        plan = kernel_plan(ms)
        log(f"phase 7 brace scan tile at MS {ms}: {plan['rows']} rows a "
            f"block, {plan['smem']} bytes of shared memory a block, "
            f"{plan['blocks_per_sm']} blocks an SM")
    line = scan_times(card)
    # the kernel's parts at 131,072 x 96 cold: every length 0 copies the
    # rows and scans nothing; rows of no bytes leave the launch, the
    # lengths read and the results written
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = [scan_rows(131_072 - 2 * len(SCAN_EDGES), 96, gen)[0]
            for _ in range(8)]
    zeros = torch.zeros(131_072, dtype=torch.int32, device="cuda")
    copy_ms = time_scan(brace_scan, [(b, zeros) for b in rows], 24)
    del rows
    empty = torch.empty((131_072, 0), dtype=torch.uint8, device="cuda")
    frame_ms = time_scan(brace_scan, [(empty, zeros)], 24)
    log(f"phase 7 brace scan parts at 131,072 x 96 cold [{card}]: every "
        f"length 0 (the copy, no scan) {copy_ms:.5f} ms/call; 131,072 x 0 "
        f"(launch, lengths and results only) {frame_ms:.5f} ms/call; the "
        f"whole {line['ms']:.5f}")
    return line


class CheckedScan:
    """Stands in for the brace scan inside the interpolation kernel: calls
    the kernel and, while ``check`` is set, the plain version on the same
    inputs, compared at once; while ``timing`` is set, records CUDA events
    around each kernel call."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain = kernel, plain
        self.check = self.timing = False
        self.compared = self.worst = 0
        self.events = []

    def __call__(self, bufs, lengths):
        import torch
        if self.timing:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = self.kernel(bufs, lengths)
        if self.timing:
            ev[1].record()
            self.events.append(ev)
        if self.check:
            want = self.plain(bufs, lengths)
            diff = int((out.long() - want.long()).abs().max()) \
                if out.numel() else 0
            self.worst = max(self.worst, diff)
            self.compared += 1
            if diff:
                raise AssertionError("phase 8: brace-scan kernel and plain "
                                     "version differ on the main path")
        return out

    def seconds(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3


class CheckedRegroup:
    """Inside the block, every regroup of a turbo launch held to its plain
    version: for each launch that ``launch_order`` regroups, the rows' pc
    and status columns (C_PC and C_STATUS, the first two) and the
    permutation are copied on the card as the launches queue, with no host
    sync, and compared with ``regroup_reference`` of those columns on exit.
    ``moved`` counts the permutations that are not the identity."""

    def __init__(self, phase: str):
        self.phase = phase
        self.calls = []
        self.compared = self.moved = self.worst = 0

    def __enter__(self):
        from interpolation_engine_tpu_torch.ops import turbo_step as ts
        self.ts, self.real = ts, ts.launch_order

        def checked(tables, regs, tile, sms):
            order = self.real(tables, regs, tile, sms)
            if order is not None:
                self.calls.append((regs[:, :2].clone(), order.clone(),
                                   tables.host.n_instr))
            return order
        ts.launch_order = checked
        return self

    def __exit__(self, *exc):
        import torch
        self.ts.launch_order = self.real
        if exc[0] is not None:
            return False
        for cols, perm, n_instr in self.calls:
            want = self.ts.regroup_reference(cols, n_instr)
            diff = int((perm.long() - want.long()).abs().max()) \
                if perm.numel() else 0
            self.worst = max(self.worst, diff)
            self.compared += 1
            self.moved += not torch.equal(
                perm, torch.arange(perm.numel(), dtype=perm.dtype,
                                   device=perm.device))
            if diff:
                raise AssertionError(f"{self.phase}: the regroup and its "
                                     f"plain version differ")
        self.calls = []
        return False


def mw_launches(got) -> dict:
    """M and W's launches in ``got`` (``counts``)."""
    return {"math": got["kernel.math_eval"],
            "match": got["kernel.wildcard_match"]}


class CheckedMW:
    """While entered, stands in for the math evaluator's and the wildcard
    matcher's entry points on the main path (``eval_flat``,
    ``_eval_enum_minmax``, ``wildcard_match``, which launch M and W on the
    card): every call goes to the entry point and to the plain version on
    the same inputs, compared field by field at once."""

    def __init__(self, phase: str):
        self.phase = phase
        self.compared = {"math": 0, "match": 0}
        self.worst = 0

    def held(self, name: str, got, want) -> None:
        diff = max_abs_diff(got, want)
        self.worst = max(self.worst, diff)
        self.compared[name] += 1
        if diff:
            raise AssertionError(f"{self.phase}: the {name} kernel and its "
                                 f"plain version differ on the main path")

    def __enter__(self):
        from interpolation_engine_tpu_torch.ops import match_kernel as mk
        from interpolation_engine_tpu_torch.ops import math_kernel as mak
        self.saved = (mak.eval_flat, mak._eval_enum_minmax, mk.wildcard_match)
        flat, enum, match = self.saved

        def checked_flat(buf, length):
            out = flat(buf, length)
            self.held("math", out, mak.eval_flat_reference(buf, length))
            return out

        def checked_enum(buf, length, want_max):
            out = enum(buf, length, want_max)
            self.held("math", out, mak.eval_enum_minmax_reference(
                buf, length, want_max))
            return out

        def checked_match(pat, plen, subj, slen, max_stars):
            out = match(pat, plen, subj, slen, max_stars)
            self.held("match", out, mk.wildcard_match_reference(
                pat, plen, subj, slen, max_stars))
            return out
        mak.eval_flat, mak._eval_enum_minmax = checked_flat, checked_enum
        mk.wildcard_match = checked_match
        return self

    def __exit__(self, *exc):
        from interpolation_engine_tpu_torch.ops import match_kernel as mk
        from interpolation_engine_tpu_torch.ops import math_kernel as mak
        mak.eval_flat, mak._eval_enum_minmax, mk.wildcard_match = self.saved
        return False


def phase8(card: str, n: int = 131_072) -> dict:
    """The general engine at the bench's width, brace scan checked."""
    from interpolation_engine_tpu_torch import bench
    import torch
    from interpolation_engine_tpu_torch._shared import vm_config
    from interpolation_engine_tpu_torch.ops import brace_scan as scan_mod
    from interpolation_engine_tpu_torch.ops import interp_kernel as ik
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner

    runner = DeviceRunner(compile_src(bench.adventure_program()),
                          vm_config.VMConfig(**bench.GENERAL_CFG),
                          device="cuda")
    checked = CheckedScan(scan_mod.brace_scan, scan_mod.brace_scan_reference)
    ik.scan_mod = type("ScanHook", (), {"brace_scan": checked})
    inner = 8
    try:
        checked.check = True
        with CheckedMW("phase 8") as mw:
            b = runner.make_instances(n)
            for _ in range(2):
                b = runner.launch(b, inner)
            torch.cuda.synchronize()
        checked.check = False
        if checked.compared == 0 or mw.compared["match"] == 0:
            raise AssertionError(f"phase 8: brace-scan calls compared "
                                 f"{checked.compared}, M and W "
                                 f"{mw.compared}")
        log(f"phase 8 general adventure [{card}]: {checked.compared} "
            f"brace-scan calls, {mw.compared['math']} math-evaluator and "
            f"{mw.compared['match']} wildcard calls in the first 2 launches "
            f"at {n} instances, each bit-identical to the plain version")
        del b

        # the bench's measurement, its warm launch counted
        batch = runner.make_instances(n)
        torch.cuda.synchronize()
        with counts() as got:
            t0 = time.perf_counter()
            warm = runner.launch(batch, inner)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        del warm
        state = batch
        before = int(state.steps.long().sum())
        checked.timing = True
        t0 = time.perf_counter()
        for _ in range(8):
            state = runner.launch(state, inner)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        checked.timing = False
        on_main_path("phase 8", got, "brace_scan")
    finally:
        ik.scan_mod = scan_mod
    steps = int(state.steps.long().sum()) - before
    status = state.status
    if not bool(((status == 0) | (status == 1) | (status == 2)).all()):
        raise AssertionError("phase 8: a row ended in ERROR or OVERFLOW")
    scan_s = checked.seconds()
    log(f"phase 8 general adventure bench [{card}]: {n} instances, warm "
        f"launch {warm_s:.3f} s, 8 launches x {inner} steps: {steps} steps "
        f"in {elapsed:.3f} s = {steps / elapsed:.1f} tasks/s; "
        f"{scan_s:.4f} s in the brace scan = {scan_s / elapsed:.4f} of wall "
        f"time; in the warm launch {got['kernel.brace_scan']} brace-scan "
        f"launches, M and W {json.dumps(mw_launches(got))}; running "
        f"{int((status == 0).sum())}, parked {int((status == 2).sum())}")
    return {"counts": got, "max_abs_err": checked.worst,
            "mw_max_abs_err": mw.worst}


def phase9(card: str, tmp: str, n: int = 4096) -> None:
    """The general engine to DONE through the ring."""
    from interpolation_engine_tpu_torch import bench
    import torch
    from interpolation_engine_tpu_torch._shared import io_manager, vm_config
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    src = bench.adventure_program(t_max=40)
    host = run_host(src, io_manager.IOManager(io_manager.BufferBackend()),
                    tmp)
    runner = DeviceRunner(compile_src(src),
                          vm_config.VMConfig(**bench.GENERAL_CFG),
                          device="cuda")
    t0 = time.perf_counter()
    final = runner.run(runner.make_instances(n))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    want = (host["output"], dict(host["inserts"]))
    for i, r in enumerate(runner.results(final)):
        if r.status != vm_config.DONE or (r.output, r.inserts) != want:
            raise AssertionError(f"phase 9: instance {i}: {r} != {want}")
    log(f"phase 9 general adventure ring [{card}]: {n} instances (cut from "
        f"131,072: about 13 per-row host services each), all DONE with the "
        f"host's {len(want[0].encode())}-byte output and inserts in "
        f"{elapsed:.3f} s; ring_stats {json.dumps(runner.ring_stats)}")


def phase10(tmp: str, not_turbo: dict) -> None:
    """The port's CLI routes a program the turbo planner rejects to the
    general engine."""
    from interpolation_engine_tpu_torch import cli
    from interpolation_engine_tpu_torch._shared import planner
    from interpolation_engine_tpu_torch.vm import driver
    import io
    for name, src in not_turbo.items():
        try:
            planner.plan_turbo(compile_src(src))
        except planner.NotTurbo:
            pass
        else:
            raise AssertionError(f"phase 10 {name}: the planner accepts it")
        path = os.path.join(tmp, f"{name}.json5")
        with open(path, "w") as f:
            f.write(src)
        host = subprocess.run(
            [sys.executable, "-m", "interpolation_engine_tpu_torch.cli", path],
            cwd=ROOT, capture_output=True, text=True, check=True,
            timeout=300).stdout
        # batch 4 runs the general engine's batch, batch 1 the interactive
        # DeviceProgramRun (the Esc menu's route)
        for batch in (4, 1):
            runs, menus = [], []
            launch = driver.DeviceRunner.launch
            menu_run = driver.DeviceProgramRun.run

            def counted(self, b, inner, _launch=launch):
                runs.append(b.n)
                return _launch(self, b, inner)

            def menu_counted(self, _run=menu_run):
                menus.append(self)
                return _run(self)

            driver.DeviceRunner.launch = counted
            driver.DeviceProgramRun.run = menu_counted
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out), counts() as got:
                    rc = cli.main(["--engine", "device", "--batch",
                                   str(batch), path])
            finally:
                driver.DeviceRunner.launch = launch
                driver.DeviceProgramRun.run = menu_run
            port = out.getvalue()
            if rc != 0 or port != host:
                raise AssertionError(f"phase 10 {name}: port CLI {port!r} "
                                     f"(rc {rc}) != host {host!r}")
            if not runs or set(runs) != {batch} or \
                    len(menus) != (batch == 1) or \
                    got["kernel.brace_scan"] <= 0 or \
                    got["kernel.turbo_step"] != 0:
                raise AssertionError(
                    f"phase 10 {name}: general-engine launches {len(runs)}, "
                    f"DeviceProgramRuns {len(menus)}, counters {dict(got)}")
            route = "DeviceProgramRun" if batch == 1 else "general engine"
            log(f"phase 10 cli {name}: --engine device --batch {batch} "
                f"printed {port!r}, as the host CLI, through the {route} "
                f"({len(runs)} launches, {got['kernel.brace_scan']} "
                f"brace-scan launches)")


def timed_on(fn, batch, launches: int, devices,
             queued: bool = False) -> float:
    """Seconds for ``launches`` calls of fn(batch), by CUDA events on every
    device that runs them: the longest of the devices' spans (``queued``
    as in ``timed``)."""
    import torch
    marks = {}
    for dev in dict.fromkeys(devices):
        with torch.cuda.device(dev):
            if queued:
                torch.cuda._sleep(QUEUE_CYCLES)
            marks[dev] = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            marks[dev][0].record()
    for _ in range(launches):
        fn(batch)
    for dev, (_, end) in marks.items():
        with torch.cuda.device(dev):
            end.record()
    for dev in marks:
        torch.cuda.synchronize(dev)
    return max(a.elapsed_time(b) for a, b in marks.values()) / 1e3


def sync_all() -> None:
    import torch
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def phase11_mesh(card: str):
    """Phase 11's mesh: every card when there are two or more, else four
    shards on ``cuda:0``."""
    import torch
    from interpolation_engine_tpu_torch.parallel.mesh import make_mesh
    if torch.cuda.device_count() >= 2:
        mesh, how = make_mesh(), "one shard on each card"
    else:
        mesh, how = make_mesh(devices=["cuda:0"] * 4), "four shards on cuda:0"
    log(f"phase 11 mesh [{card}]: {len(mesh)} shards, {how}")
    return mesh


def mesh_launches(card: str, mesh, n: int = 131_072) -> dict:
    """Phase 11's sharded step on the adventure program: held against the
    unsharded step and its plain version on the same shards over two
    launches, then timed in turns with the unsharded step. Returns the
    sharded step's and plain version's ms a step, its bound and
    deviation."""
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        sharded_turbo_step_reference)
    from interpolation_engine_tpu_torch.parallel.mesh import (
        shard_turbo_batch, unshard)
    from interpolation_engine_tpu_torch.vm.turbo import C_STEPS, TurboEngine

    tcfg = adventure_tcfg()
    K = tcfg.k_steps
    src = bench.adventure_program()
    one = TurboEngine(compile_src(src), tcfg, device=mesh[0])
    many = TurboEngine(compile_src(src), tcfg, mesh=mesh)
    b0 = one.make_batch(n)
    ref = clone(b0)
    kern, plain = shard_turbo_batch(b0, mesh), shard_turbo_batch(b0, mesh)
    step_one, step_many = one.step_fn(n), many.step_fn(n)
    worst = 0
    for k in range(2):
        step_one(ref)
        step_many(kern)
        sharded_turbo_step_reference(many.step_tables, plain, K)
        sync_all()
        got = unshard(kern)
        d_one, d_plain = max_abs_diff(got, ref), max_abs_diff(got,
                                                             unshard(plain))
        worst = max(worst, d_one, d_plain)
        if d_one or d_plain:
            raise AssertionError(f"phase 11: after launch {k + 1} the sharded "
                                 f"step differs from the unsharded step "
                                 f"({d_one}) or its plain version "
                                 f"({d_plain})")
    launch_bound = mesh_step_bound(one.tables, b0,
                                   ref.regs[:, C_STEPS].long(), mesh,
                                   kern.offsets, 2)
    del ref, kern, plain, got
    # the first L launches from the same state, in turns: unsharded,
    # sharded, sharded, unsharded
    L = 2
    t_one, t_many = [], []
    for which in (t_one, t_many, t_many, t_one):
        if which is t_one:
            which.append(timed_on(step_one, clone(b0), L, mesh[:1], True))
        else:
            which.append(timed_on(step_many, shard_turbo_batch(b0, mesh), L,
                                  mesh, True))
    t_plain = timed_on(lambda b: sharded_turbo_step_reference(
        many.step_tables, b, K), shard_turbo_batch(b0, mesh), L, mesh)
    tile = tile_line(one.tables, b0, tcfg.tile)
    del b0
    t_many_all, t_many = t_many, sum(t_many) / len(t_many)

    def ms(ts):
        return " and ".join(f"{t / L * 1e3:.3f}" for t in ts)
    log(f"phase 11 adventure, first {L} launches x {K} steps at {n} "
        f"instances [{card}]: the sharded step bit-identical to the "
        f"unsharded step and to its plain version on the same shards; "
        f"ms/step in turns: unsharded {ms(t_one[:1])}, sharded "
        f"{ms(t_many_all)}, unsharded {ms(t_one[1:])}; plain version on "
        f"the shards {t_plain / L * 1e3:.3f}; {tile}")
    return {"max_abs_err": worst, "ms": t_many / L * 1e3,
            "plain_ms": t_plain / L * 1e3, **launch_bound}


def phase11(card: str, tmp: str, n: int = 131_072,
            n_ring: int = 4096) -> dict:
    """The turbo engine over a mesh: the sharded step held against the
    unsharded step and its plain version, then the sharded main path and
    race-io through the sharded ring."""
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch._shared import io_manager
    from interpolation_engine_tpu_torch.parallel.mesh import unshard
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, DONE, TurboConfig, TurboEngine)

    mesh = phase11_mesh(card)
    stepped = mesh_launches(card, mesh, n)
    tcfg = adventure_tcfg()

    # the sharded main path: run_async to the end at 40 turns, counted
    src40 = bench.adventure_program(t_max=40)
    host = run_host(src40, io_manager.IOManager(io_manager.BufferBackend()),
                    tmp)
    eng = TurboEngine(compile_src(src40), tcfg, mesh=mesh)
    batch = eng.make_batch(n)
    sync_all()
    with counts() as got:
        t0 = time.perf_counter()
        final = eng.run(batch)
        sync_all()
        elapsed = time.perf_counter() - t0
    # a sharded launch is one kernel launch on each shard
    on_main_path("phase 11", got, "turbo_step")
    shards = got["kernel.turbo_step"]
    launches = shards // len(mesh)
    if shards % len(mesh):
        raise AssertionError(f"phase 11: {shards} shard launches over "
                             f"{len(mesh)} shards")
    flat = unshard(final)
    check_all_done("phase 11", eng, flat, host)
    total = int(flat.regs[:, C_STEPS].long().sum())
    del batch, final, flat
    log(f"phase 11 adventure main path over the mesh [{card}]: {n} "
        f"instances DONE with the host's output and inserts, {launches} "
        f"sharded launches ({shards} shard launches), "
        f"{eng.ring_stats['parks']} parks, {total} steps in {elapsed:.3f} s "
        f"= {total / elapsed:.1f} tasks/s end to end")

    # race-io through the sharded ring: the fast park path, then the exact
    # ring (every park gathered from its shard, serviced through the
    # LaneRing under its global id and scattered back)
    src = bench.race_io_program(t_max=3)
    host = run_host(src, canned_io("cgo"), tmp)
    want = (host["output"], dict(host["inserts"]), DONE, 47)
    runs = {}
    for fast in (True, False):
        with fast_ring(fast):
            eng = TurboEngine(compile_src(src), TurboConfig(
                width=128, out_width=128, k_steps=16, list_cap=12,
                elem_width=32), io_factory=lambda i: canned_io("cgo"),
                mesh=mesh)
        final, ring_s, exact, lanes = ring_run(eng, n_ring)
        flat = unshard(final)
        check_all_done("phase 11 race-io", eng, flat, host)
        res = [summary(r) for r in eng.results(final)]
        for i, r in enumerate(res):
            if r != want:
                raise AssertionError(f"phase 11 race-io: instance {i}: {r} "
                                     f"!= {want}")
        rs = eng.ring_stats
        n_fast = 3 * n_ring if fast else 0
        if rs["parks"] != 3 * n_ring or rs["fast_parks"] != n_fast or \
                lanes != exact or lanes != 3 * n_ring - n_fast:
            raise AssertionError(
                f"phase 11 race-io: {rs['parks']} parks, {rs['fast_parks']} "
                f"fast, {lanes} through the lane servicing; want "
                f"{3 * n_ring} parks, {n_fast} fast")
        runs[fast] = res, int(flat.regs[:, C_STEPS].long().sum())
        path = "fast park path" if fast else "exact ring (fast path off)"
        log(f"phase 11 race-io over the mesh, {path} [{card}]: {n_ring} "
            f"instances (cut from 16,384 to keep the script short), "
            f"{rs['parks']} lane parks in {rs['rounds']} rounds "
            f"({fast_split(eng)}, {lanes} through _service_lanes), "
            f"{ring_s:.3f} s, all DONE with the host's output and 47 steps "
            f"each")
    if runs[True] != runs[False]:
        raise AssertionError("phase 11 race-io: the exact ring differs from "
                             "the fast park path")
    log(f"phase 11 race-io over the mesh: the exact run equals the fast run "
        f"instance for instance, {runs[True][1]} steps in both")
    return {"launches": launches, **stepped}


def phase12(card: str, tmp: str, single: dict, n: int = 16_384) -> None:
    """The bench's race-io shape: two sibling engines pipelined on one
    card, through the fast park path and then through the exact ring."""
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, TurboConfig, assign_shard_ids, make_shard_engines,
        run_pipelined)
    src = bench.race_io_program(t_max=3)
    host = run_host(src, canned_io("cgo"), tmp)
    want = (host["output"], dict(host["inserts"]))
    runs = {}
    for fast in (True, False):
        with fast_ring(fast):
            engines = make_shard_engines(
                compile_src(src), TurboConfig(
                    width=128, out_width=128, k_steps=16, list_cap=12,
                    elem_width=32), 2,
                io_factory=lambda i: canned_io("cgo"), device="cuda")
        assign_shard_ids(engines, n // 2)
        counts = count_services(engines)
        pairs = [(e, e.make_batch(n // 2)) for e in engines]
        sync_all()
        t0 = time.perf_counter()
        finals = asyncio.run(run_pipelined(pairs))
        sync_all()
        elapsed = time.perf_counter() - t0
        total = parks = n_fast = 0
        res = []
        for s, (eng, final) in enumerate(zip(engines, finals)):
            check_all_done(f"phase 12 shard {s}", eng, final, host)
            for i, r in enumerate(eng.results(final)):
                if (r.output, r.inserts) != want:
                    raise AssertionError(f"phase 12 shard {s}: instance {i}: "
                                         f"{r} != {want}")
                res.append(summary(r))
            total += int(final.regs[:, C_STEPS].long().sum())
            parks += eng.ring_stats["parks"]
            n_fast += eng.ring_stats["fast_parks"]
        lanes = counts["_service_lanes"]
        want_fast = parks if fast else 0
        if total != single["steps"] or parks != 3 * n or \
                n_fast != want_fast or lanes != counts["_service"] or \
                lanes != parks - n_fast or single["n"] != n:
            raise AssertionError(
                f"phase 12: {total} steps, {parks} parks, {n_fast} fast, "
                f"{lanes} through the lane servicing; want phase 6's "
                f"{single['steps']} steps at {single['n']}, {3 * n} parks, "
                f"{want_fast} fast")
        runs[fast] = res
        path = "fast park path" if fast else "exact ring (fast path off)"
        log(f"phase 12 race-io, 2 pipelined shard engines on one card, "
            f"{path} [{card}]: {n} instances DONE with the host's output "
            f"and inserts, {total} steps (= phase 6's exact ring at {n}), "
            f"{parks} lane parks, {n_fast} on the fast path, {lanes} through "
            f"_service_lanes; ring wall time {elapsed:.3f} s against phase "
            f"6's exact ring's {single['seconds']:.3f} s")
    if runs[True] != runs[False]:
        raise AssertionError("phase 12: the exact ring differs from the fast "
                             "park path")
    log("phase 12 race-io: the exact run equals the fast run instance for "
        "instance")


def phase13(card: str, tmp: str, n: int = 16_384, every: int = 16,
            checked: int = 2) -> dict:
    """Promotion mid-run at the bench's width-512 shape: the sibling's first
    ``checked`` kernel launches held against the plain version, then its
    launch timed. Returns the ring's wall time and the sibling's launch
    (s, ms)."""
    from interpolation_engine_tpu_torch import bench
    import torch
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        launch_plan, turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, DONE, TurboConfig, TurboEngine)
    src = bench.race_io_program(t_max=3)
    # the long answer still starts with 'c', so the instance plays on
    answers = {False: ["cgo"] * 3, True: ["c" + "L" * 999, "cgo", "cgo"]}
    want = {}
    for big, said in answers.items():
        host = run_host(src, iom.IOManager(iom.ScriptedBackend(list(said))),
                        tmp)
        want[big] = (host["output"], dict(host["inserts"]), DONE, 47)
    tcfg = TurboConfig(width=512, out_width=512, k_steps=16, list_cap=12,
                       elem_width=128)
    eng = TurboEngine(compile_src(src), tcfg, io_factory=lambda i:
                      iom.IOManager(iom.ScriptedBackend(
                          list(answers[i % every == 0]))), device="cuda")
    # the sibling's steps: the first ``checked`` held against the plain
    # version on a copy of the same batch
    sib = {"held": 0, "worst": 0, "first": None, "tables": None}
    make = TurboEngine.step_fn

    def step_fn(self, rows):
        step = make(self, rows)
        if self.tcfg.width == tcfg.width:
            return step

        def held(batch):
            if sib["held"] >= checked:
                return step(batch)
            ref = clone(batch)
            if sib["first"] is None:
                sib["first"], sib["tables"] = clone(batch), self.tables
                sib["tcfg"] = self.tcfg
            step(batch)
            turbo_step_reference(self.tables, ref, self.tcfg.k_steps)
            torch.cuda.synchronize()
            diff = max_abs_diff(batch, ref)
            sib["worst"] = max(sib["worst"], diff)
            sib["held"] += 1
            if diff:
                raise AssertionError(f"phase 13: the sibling's kernel and "
                                     f"plain version differ after launch "
                                     f"{sib['held']}")
            return batch
        return held

    TurboEngine.step_fn = step_fn
    try:
        with counts() as got:
            final, elapsed, exact, _ = ring_run(eng, n)
    finally:
        TurboEngine.step_fn = make
    # the ring's launches, before the sibling's are timed below
    on_main_path("phase 13", got, "turbo_step", plain=checked)
    launches = got["kernel.turbo_step"]
    warp_launches = got["turbo.warp_row_launches"]
    promoted = list(range(0, n, every))
    if sorted(eng._escape_results) != promoted or exact != 0 or \
            sib["held"] != checked:
        raise AssertionError(
            f"phase 13: {len(eng._escape_results)} instances promoted, "
            f"{exact} exact services, {sib['held']} sibling launches held")
    res = eng.results(final)
    for i, r in enumerate(res):
        if summary(r) != want[i % every == 0]:
            raise AssertionError(f"phase 13: instance {i}: {r} != "
                                 f"{want[i % every == 0]}")
    wide, tables, first = sib["tcfg"], sib["tables"], sib["first"]
    K, L = wide.k_steps, 4
    kern = clone(first)
    k_ms = timed(lambda b: turbo_step(tables, b, K), kern, L, True) / L * 1e3
    p_ms = timed(lambda b: turbo_step_reference(tables, b, K), clone(first),
                 L) / L * 1e3
    steps = int((kern.regs[:, C_STEPS] - first.regs[:, C_STEPS]).sum())
    sib_bound = step_bound(tables, first, steps // L)
    log(f"phase 13 promotion [{card}]: race-io at width {tcfg.width}, "
        f"{n} instances, every {every}th answering 1,000 bytes at turn 1: "
        f"{len(promoted)} promoted mid-run to one sibling of width "
        f"{wide.width} (out {wide.out_width}, elements {wide.elem_width}), "
        f"{eng.ring_stats['escapes']} queued; its first {checked} kernel "
        f"launches bit-identical to the plain version; every instance DONE "
        f"equal to the host with 47 steps; {fast_split(eng)}, no exact "
        f"service; {launches} kernel launches in {elapsed:.3f} s, "
        f"{warp_launches} of them the sibling's, a warp a row")
    if plan_lanes(launch_plan(tables, first, wide.tile)) > 1 and \
            warp_launches <= 0:
        raise AssertionError("phase 13: the sibling stepped no row with a "
                             "warp")
    log(f"phase 13 sibling step at width {wide.width}, {len(promoted)} "
        f"instances, first launch's state, K={K} [{card}]: kernel "
        f"{k_ms:.3f} ms/launch (queued), plain version {p_ms:.3f} ms/launch; "
        f"bound {sib_bound['bound_ms']:.4f} ms ({sib_bound['bound_by']}), "
        f"the kernel at {sib_bound['bound_ms'] / k_ms * 100:.1f} % of it; "
        f"{tile_line(tables, first, wide.tile)}")
    return {"ring_s": elapsed, "sibling_ms": k_ms, "counts": got,
            "max_abs_err": sib["worst"]}


def host_with_choice(src: str, tmp: str, pick: int) -> dict:
    """The host engine's final state where its random_choice takes element
    ``pick`` (the device's, by the JAX LCG; the host's own is Python's
    generator)."""
    import random
    from interpolation_engine_tpu_torch._shared import io_manager
    old = random.choice
    random.choice = lambda seq: seq[pick]
    try:
        return run_host(src, io_manager.IOManager(io_manager.BufferBackend()),
                        tmp)
    finally:
        random.choice = old


def check_groups(name: str, host: dict, groups: dict, want: dict) -> None:
    """Every general-engine row equals the host: the rows of one group
    (same expected result) are compared field by field with the group's
    first row (``rng`` aside), which is decoded and held against ``want``;
    a row that differs from it is decoded on its own."""
    import numpy as np
    from interpolation_engine_tpu_torch.vm import state as vs
    for key, rows in groups.items():
        first = vs.row_of(host, rows[0])
        same = np.ones(len(rows), bool)
        for f in vs.FIELDS:
            if f != "rng":
                a = host[f][rows]
                same &= (a == a[:1]).reshape(len(rows), -1).all(axis=1)
        for r in [rows[0]] + [int(x) for x in rows[~same]]:
            st = vs.row_of(host, r) if r != rows[0] else first
            got = (int(st["status"]), vs.decode_output(st),
                   vs.decode_inserts(st))
            if got != want[key]:
                raise AssertionError(f"{name}: instance {r}: {got} != "
                                     f"{want[key]}")


def count_torch_calls(runner, batch, names: dict) -> dict:
    """Torch calls (``__torch_function__`` dispatches: tensor ops, copies
    and host reads) of one step of each handler, on ``batch`` run to its
    end: handler name -> calls per step."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    step = runner.step
    run_group = step._run_group
    calls, groups = {}, {}

    def counted(st, pc):
        name = names[int(step.code[pc][0])]
        Count.n = 0
        with Count():
            out = run_group(st, pc)
        calls[name] = calls.get(name, 0) + Count.n
        groups[name] = groups.get(name, 0) + 1
        return out
    step._run_group = counted
    try:
        runner.launch(batch, 64)
    finally:
        step._run_group = run_group
    return {k: calls[k] // groups[k] for k in sorted(
        calls, key=lambda k: -calls[k] / groups[k])}


def phase14(card: str, tmp: str, n: int = 131_072) -> None:
    """The general engine's 11 opcodes past its first 19 (GENERAL_OPS) at
    the bench's width, brace scan checked in the first launches, then run
    to DONE with every instance held against the host."""
    import numpy as np
    import torch
    import torch_programs as tp
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch._shared import isa, vm_config
    from interpolation_engine_tpu_torch.ops import brace_scan as scan_mod
    from interpolation_engine_tpu_torch.ops import interp_kernel as ik
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    src = tp.GENERAL_OPS
    want = {}
    for pick in range(3):
        host = host_with_choice(src, tmp, pick)
        want[pick] = (vm_config.DONE, host["output"], dict(host["inserts"]))
    runner = DeviceRunner(compile_src(src),
                          vm_config.VMConfig(**bench.GENERAL_CFG),
                          device="cuda")
    checked = CheckedScan(scan_mod.brace_scan, scan_mod.brace_scan_reference)
    ik.scan_mod = type("ScanHook", (), {"brace_scan": checked})
    inner = 8
    try:
        checked.check = True
        with CheckedMW("phase 14") as mw:
            b = runner.make_instances(n)
            for _ in range(2):
                b = runner.launch(b, inner)
            torch.cuda.synchronize()
        checked.check = False
    finally:
        ik.scan_mod = scan_mod
    if checked.compared == 0 or min(mw.compared.values()) == 0:
        raise AssertionError(f"phase 14: brace-scan calls compared "
                             f"{checked.compared}, M and W {mw.compared}")
    del b
    torch_calls = count_torch_calls(runner, runner.make_instances(4096),
                                    isa.OP_NAMES)

    launches = []
    launch = runner.launch

    def counted(batch, k):
        launches.append(k)
        return launch(batch, k)
    runner.launch = counted
    batch = runner.make_instances(n)
    torch.cuda.synchronize()
    with counts() as got:
        t0 = time.perf_counter()
        final = runner.run(batch, inner_steps=inner)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    on_main_path("phase 14", got, "brace_scan", "math_eval",
                 "wildcard_match")
    host = final.to_numpy()
    picks = np.asarray([tp.general_ops_choice(i + 1) for i in range(n)])
    check_groups("phase 14", host, {k: np.nonzero(picks == k)[0]
                                    for k in range(3)}, want)
    steps = int(host["steps"].astype(np.int64).sum())
    log(f"phase 14 general engine, the 11 opcodes (GENERAL_OPS) "
        f"[{card}]: {checked.compared} brace-scan calls, "
        f"{mw.compared['math']} math-evaluator and {mw.compared['match']} "
        f"wildcard calls in the first 2 launches at {n} instances, each "
        f"bit-identical to the plain version; then {n} instances to DONE, "
        f"each equal to the host (random_choice by the JAX LCG from rng = "
        f"row + 1): {steps} steps in {len(launches)} launches x {inner} "
        f"steps, {elapsed:.3f} s = {steps / elapsed:.1f} tasks/s; "
        f"{got['kernel.brace_scan']} brace-scan launches, M and W "
        f"{json.dumps(mw_launches(got))}; "
        f"ring_stats {json.dumps(runner.ring_stats)}")
    log(f"phase 14 torch calls per step by handler (4,096 instances): "
        f"{json.dumps(torch_calls)}")
    return {"counts": got, "mw_max_abs_err": mw.worst}


def phase15(card: str, tmp: str, n: int = 16_384, every: int = 16,
            n_mesh: int = 4096) -> None:
    """Escapes: race-io at the bench's width-512 shape where one instance
    in ``every`` answers 3,000 bytes at turn 1, wider than the 2,048-byte
    sibling: those instances escape to one general-engine batch. Then the
    same from the mesh engine (four shards of cuda:0, or one per card)."""
    from interpolation_engine_tpu_torch import bench
    import torch
    from interpolation_engine_tpu_torch._shared import io_manager as iom
    from interpolation_engine_tpu_torch.vm.turbo import (
        DONE, TurboConfig, TurboEngine)
    src = bench.race_io_program(t_max=3)
    # the long answer starts with 'c', so the instance plays on
    answers = {False: ["cgo"] * 3, True: ["c" + "L" * 2999, "cgo", "cgo"]}
    want = {}
    for big, said in answers.items():
        host = run_host(src, iom.IOManager(iom.ScriptedBackend(list(said))),
                        tmp)
        want[big] = (host["output"], dict(host["inserts"]), DONE)
    tcfg = TurboConfig(width=512, out_width=512, k_steps=16, list_cap=12,
                       elem_width=128)
    n_cards = torch.cuda.device_count()
    mesh = ([f"cuda:{d}" for d in range(n_cards)] if n_cards > 1
            else ["cuda:0"] * 4)
    total = Counter()
    for label, size, kw in (("one card", n, {"device": "cuda"}),
                            (f"mesh of {len(mesh)} shards", n_mesh,
                             {"mesh": mesh})):
        eng = TurboEngine(compile_src(src), tcfg, io_factory=lambda i:
                          iom.IOManager(iom.ScriptedBackend(
                              list(answers[i % every == 0]))), **kw)
        with counts() as got:
            final, elapsed, exact, _ = ring_run(eng, size)
        total.update(got)
        escaped = list(range(0, size, every))
        if sorted(eng._escape_results) != escaped or \
                eng.ring_stats["escapes"] != len(escaped) or \
                len(eng.escape_runners) != 1:
            raise AssertionError(
                f"phase 15 {label}: {len(eng._escape_results)} escaped, "
                f"escapes {eng.ring_stats['escapes']}, "
                f"{len(eng.escape_runners)} runners")
        on_main_path(f"phase 15 {label}", got, "turbo_step", "brace_scan")
        for i, r in enumerate(eng.results(final)):
            if (r.output, r.inserts, r.status) != want[i % every == 0]:
                raise AssertionError(f"phase 15 {label}: instance {i}: "
                                     f"{r} != {want[i % every == 0]}")
        [runner] = eng.escape_runners
        steps = sorted({r.steps for r in eng.results(final)})
        log(f"phase 15 escapes, {label} [{card}]: race-io at width "
            f"{tcfg.width}, {size} instances, every {every}th answering "
            f"3,000 bytes at turn 1: {len(escaped)} escaped (ring_stats "
            f"escapes {eng.ring_stats['escapes']}) to one general-engine "
            f"batch (max_str {runner.cfg.max_str}, arena "
            f"{runner.cfg.arena_size} bytes) on {runner.device}; every "
            f"instance DONE equal to the host (steps {steps}); "
            f"{fast_split(eng)}; {got['kernel.turbo_step']} step-kernel "
            f"and {got['kernel.brace_scan']} brace-scan launches in "
            f"{elapsed:.3f} s; the escape runner's ring_stats "
            f"{json.dumps(runner.ring_stats)}")
    # a program of 151 byte rows at the same width: one instance of its
    # 2048-wide sibling does not fit a block's shared memory, so no sibling
    # is built and the instances that outgrow their slot escape
    import torch_programs as tp
    src = tp.many_rows_program()
    answers = {False: ["short"], True: ["Z" * 600]}
    want = {}
    for big, said in answers.items():
        host = run_host(src, iom.IOManager(iom.ScriptedBackend(list(said))),
                        tmp)
        want[big] = (host["output"], dict(host["inserts"]), DONE)
    size = 4096
    eng = TurboEngine(compile_src(src), tcfg, io_factory=lambda i:
                      iom.IOManager(iom.ScriptedBackend(
                          list(answers[i % every == 0]))), device="cuda")
    tile = tile_line(eng.tables, eng.make_batch(1), tcfg.tile)
    with counts() as got:
        final, elapsed, _, _ = ring_run(eng, size)
    total.update(got)
    escaped = list(range(0, size, every))
    if eng._wide_tcfg() is not None or \
            sorted(eng._escape_results) != escaped or \
            len(eng.escape_runners) != 1:
        raise AssertionError(
            f"phase 15 many rows: sibling {eng._wide_tcfg()}, "
            f"{len(eng._escape_results)} escaped, "
            f"{len(eng.escape_runners)} runners")
    on_main_path("phase 15 many rows", got, "turbo_step")
    for i, r in enumerate(eng.results(final)):
        if (r.output, r.inserts, r.status) != want[i % every == 0]:
            raise AssertionError(f"phase 15 many rows: instance {i}: "
                                 f"{r} != {want[i % every == 0]}")
    log(f"phase 15 escapes past a block's shared memory [{card}]: "
        f"{eng.cols.n_rows} byte rows at width {tcfg.width} "
        f"({tile}), no "
        f"sibling; {size} instances, every {every}th answering 600 bytes: "
        f"{len(escaped)} escaped to one general-engine batch on "
        f"{eng.escape_runners[0].device}, every instance DONE equal to the "
        f"host, {got['kernel.turbo_step']} step-kernel launches, "
        f"{elapsed:.3f} s")
    log(f"phase 15 M and W launches on the escape runners: "
        f"{json.dumps(mw_launches(total))}")
    return {"counts": total}


def run_host_from(src: str, state: dict, io, tmp: str) -> dict:
    """The host engine resumed from a reference-format state (the program's
    default_state replaced, line numbers kept)."""
    import torch_programs as tp
    return run_host(tp.with_state(src, state), io, tmp)


def state_key(state: dict) -> str:
    return json.dumps(state, sort_keys=True)


def check_classes(name: str, eng, final, cls, hosts: list) -> None:
    """Every row equals, field for field on the card, the first row of its
    class (``cls[row]``); that row, decoded, is DONE with its class's host
    output and inserts."""
    import numpy as np
    import torch
    from interpolation_engine_tpu_torch.vm.turbo import C_STATUS, DONE
    cls = np.asarray(cls)
    reps = np.asarray([int(np.argmax(cls == c)) for c in range(len(hosts))])
    idx = torch.from_numpy(reps[cls]).to(final.regs.device)
    for t, axis in zip(final, (0, 1, 0, 1)):
        if not torch.equal(t, t.index_select(axis, idx)):
            raise AssertionError(f"{name}: a row differs from its class")
    sub, _ = eng._gather_sub(final, np.sort(reps))
    order = np.argsort(reps)
    for j, c in enumerate(order):
        got = eng._decode_row(sub, j, int(reps[c]))
        host = hosts[c]
        if int(sub["regs"][j, C_STATUS]) != DONE or \
                (got["output"], got["inserts"]) != \
                (host["output"], dict(host["inserts"])):
            raise AssertionError(f"{name}: class {c}: {got} != host "
                                 f"{host}")


def phase16(card: str, tmp: str, n: int = 131_072,
            n_export: int = 1024) -> dict:
    """Resume on the turbo engine: bench.py's divergent and ring batches
    through ``load_batch`` to DONE, then a mid-run export and reload."""
    import numpy as np
    import torch
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        launch_plan, regroup, regroup_reference, regroups, sm_count,
        turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_PARMODE, C_STEPS, DONE, TurboConfig, TurboEngine)
    tcfg = TurboConfig(width=128, out_width=128, k_steps=64, list_cap=12,
                       elem_width=32)   # phase 5's
    ran = Counter()
    groups = {"compared": 0, "moved": 0, "worst": 0}

    def counted_run(eng, batch):
        sync_all()
        with CheckedRegroup("phase 16") as checked, counts() as got:
            t0 = time.perf_counter()
            final = eng.run(batch)
            sync_all()
            elapsed = time.perf_counter() - t0
        on_main_path("phase 16", got, "turbo_step")
        launches = got["kernel.turbo_step"]
        tile = launch_plan(eng.tables, batch, eng.tcfg.tile).tile
        if got["kernel.regroup"] != checked.compared or checked.compared != (
                launches if regroups(batch.regs.shape[0], tile,
                                     sm_count(batch.regs.device)) else 0):
            raise AssertionError(
                f"phase 16: {got['kernel.regroup']} regroups, "
                f"{checked.compared} compared, over {launches} launches")
        ran.update(got)
        groups["compared"] += checked.compared
        groups["moved"] += checked.moved
        groups["worst"] = max(groups["worst"], checked.worst)
        return final, elapsed

    # (a) divergent: 8 states at spread order indexes (bench.py:516-527)
    src = bench.adventure_program(t_max=40)
    eng = TurboEngine(compile_src(src), tcfg, device="cuda")
    states = bench.divergent_states(eng.compiled, eng.plan.slot_of, n,
                                     8)
    uniq = {}
    load_state = eng.load_state

    def counting(state, i=None):
        uniq[i] = state["order_index"]
        return load_state(state, i)
    eng.load_state = counting
    sync_all()
    t0 = time.perf_counter()
    batch = eng.load_batch(states)
    sync_all()
    load_s = time.perf_counter() - t0
    if len(uniq) != 8:
        raise AssertionError(f"phase 16: load_batch encoded {len(uniq)} "
                             f"distinct rows, not 8")
    kern, ref = clone(batch), clone(batch)
    turbo_step(eng.tables, kern, tcfg.k_steps)
    turbo_step_reference(eng.tables, ref, tcfg.k_steps)
    torch.cuda.synchronize()
    worst = max_abs_diff(kern, ref)
    if worst:
        raise AssertionError("phase 16: kernel and plain version differ on "
                             "the divergent batch's first launch")
    del kern, ref
    # the regroup alone on this batch (131,072 rows at 8 pcs, in turn),
    # queued, beside its plain version and its bound: each row's pc and
    # status (one 32-byte sector) read, its place written
    n_instr = eng.tables.host.n_instr
    calls = 100
    group_ms = timed(lambda b: regroup(eng.tables, b.regs), batch, calls,
                     True) / calls * 1e3
    group_plain_ms = timed(lambda b: regroup_reference(b.regs, n_instr),
                           batch, 10) / 10 * 1e3
    group_bound = bound(n * (32 + 4), 0)
    log(f"phase 16 divergent, the regroup alone [{card}]: {group_ms:.4f} "
        f"ms/call ({calls} calls queued), plain version "
        f"{group_plain_ms:.4f} ms/call; bound {group_bound['bound_ms']:.5f}"
        f" ms ({group_bound['bound_by']}), the kernels at "
        f"{group_bound['bound_ms'] / group_ms * 100:.1f} % of it")
    hosts = [run_host_from(src, states[c], canned_io(), tmp)
             for c in range(8)]
    final, elapsed = counted_run(eng, batch)
    check_classes("phase 16 divergent", eng, final, np.arange(n) % 8, hosts)
    total = int(final.regs[:, C_STEPS].long().sum())
    log(f"phase 16 divergent [{card}]: {n} instances from 8 states at "
        f"order indexes {sorted(set(uniq.values()))}, load_batch "
        f"(U = {len(uniq)}: encode, upload, gather) {load_s:.3f} s; the "
        f"first launch bit-identical to the plain version; run to DONE "
        f"{elapsed:.3f} s, {total} steps = {total / elapsed:.1f} tasks/s; "
        f"every instance equal to the host resumed from its class's state")
    del batch, final

    # (b) ring: one instance in ten at sel 'park' (bench.py:568-594)
    ring_src = bench.RING_PROGRAM.replace("'1073741824'", "'3'")
    ring = TurboEngine(compile_src(ring_src), TurboConfig(
        width=128, out_width=192, k_steps=64), io_factory=lambda i:
        canned_io(), device="cuda")
    rstates = bench.ring_states(ring.compiled, n, 0.10)
    final, elapsed = counted_run(ring, ring.load_batch(rstates))
    cls = np.asarray([0 if s["inserts"]["sel"] == "park" else 1
                      for s in rstates])
    check_classes("phase 16 ring", ring, final, cls, [
        run_host_from(ring_src, rstates[int(np.argmax(cls == c))],
                      canned_io(), tmp) for c in (0, 1)])
    rs = ring.ring_stats
    if rs["parks"] != 3 * int((cls == 0).sum()):
        raise AssertionError(f"phase 16 ring: {rs['parks']} parks")
    log(f"phase 16 ring [{card}]: {n} instances, {int((cls == 0).sum())} at "
        f"sel 'park', through load_batch and the fast park path to DONE in "
        f"{elapsed:.3f} s, every instance equal to the host for its class; "
        f"ring_stats {json.dumps(rs)}")
    del final

    # (c) a mid-run round trip: rows of a running batch exported after
    # 1, 2 and 3 launches (some inside the parallel block), loaded into a
    # fresh engine and run on. The batch starts from the 8 divergent
    # states with turns spread 24-39 (every instance reaches turn 40 in few
    # turns), so the rows differ in pc, lanes and inserts
    eng = TurboEngine(compile_src(src), tcfg, device="cuda")
    batch = eng.load_batch(bench.divergent_states(eng.compiled,
                                                  eng.plan.slot_of, n, 8))
    spread_slot(eng, batch, "turn", 16, torch.Generator().manual_seed(SEED))
    batch.regs[:, eng.cols.sint(eng.plan.slot_of["turn"])] += 24
    step = eng.step_fn(n)
    rows = np.sort(np.random.default_rng(SEED).choice(n, n_export,
                                                      replace=False))
    exported = [None] * len(rows)
    in_block, export_s = 0, 0.0
    for launch in range(3):
        step(batch)
        idx = np.arange(launch, len(rows), 3)
        in_block += int((batch.regs[torch.from_numpy(rows[idx]).to("cuda"),
                                    C_PARMODE] > 0).sum())
        sync_all()
        t0 = time.perf_counter()
        for j in idx:
            exported[j] = eng.export_state(batch, int(rows[j]))
        export_s += time.perf_counter() - t0
    export_s /= len(rows)
    if not 0 < in_block < len(rows):
        raise AssertionError(f"phase 16: {in_block} of {len(rows)} exported "
                             f"rows inside the parallel block")
    n_states = len({state_key(st) for st in exported})
    n_chains = len({state_key({k: v for k, v in st.items()
                               if k not in ("inserts", "output")})
                    for st in exported})
    if n_states < 128 or n_chains <= 8:
        raise AssertionError(f"phase 16: the exported rows hold only "
                             f"{n_states} distinct states, {n_chains} "
                             f"cursor chains")
    fresh = TurboEngine(compile_src(src), tcfg, device="cuda")
    final, elapsed = counted_run(fresh, fresh.load_batch(exported))
    hosts = {}
    for st in exported:
        if state_key(st) not in hosts:
            hosts[state_key(st)] = run_host_from(src, st, canned_io(), tmp)
    for i, (st, r) in enumerate(zip(exported, fresh.results(final))):
        host = hosts[state_key(st)]
        if r.status != DONE or (r.output, r.inserts) != \
                (host["output"], dict(host["inserts"])):
            raise AssertionError(f"phase 16 round trip: row {rows[i]}: {r} "
                                 f"!= host {host}")
    log(f"phase 16 round trip [{card}]: adventure at {n} instances from the "
        f"8 divergent states (turns spread 24-39), export_state of "
        f"{len(rows)} rows after 1, 2 and 3 launches ({in_block} inside "
        f"the parallel block) at {export_s * 1e3:.3f} ms a row: "
        f"{n_states} distinct states, {n_chains} distinct cursor chains; "
        f"load_batch of those states and run to DONE in {elapsed:.3f} s, "
        f"each row equal to the host resumed from its state")
    if groups["moved"] <= 0:
        raise AssertionError("phase 16: every regroup was the identity")
    log(f"phase 16 regroups [{card}]: {groups['compared']} over the three "
        f"runs, each equal to its plain version, {groups['moved']} not the "
        f"identity")
    return {"counts": ran, "max_abs_err": worst, "states": exported,
            "hosts": hosts,
            "regroup": {"max_abs_err": groups["worst"], "ms": group_ms,
                        "plain_ms": group_plain_ms,
                        "library_ms": group_plain_ms, **group_bound}}


def phase17(card: str, tmp: str, states: list, hosts: dict,
            n: int = 256) -> dict:
    """Resume on the general engine: phase 16's exported states through
    ``DeviceRunner.load_state``, then the device menu's Save and Load."""
    import io as io_mod
    import torch
    import torch_programs as tp
    from interpolation_engine_tpu_torch._shared import (
        io_manager, json5, loader, vm_config)
    from interpolation_engine_tpu_torch.ops import brace_scan as scan_mod
    from interpolation_engine_tpu_torch.ops import interp_kernel as ik
    from interpolation_engine_tpu_torch.vm import state as vs
    from interpolation_engine_tpu_torch.vm.driver import (DeviceProgramRun,
                                                          DeviceRunner)
    from interpolation_engine_tpu_torch import bench
    src = bench.adventure_program(t_max=40)
    runner = DeviceRunner(compile_src(src),
                          vm_config.VMConfig(**bench.GENERAL_CFG),
                          device="cuda")
    picked = states[::max(len(states) // n, 1)][:n]
    batch = vs.stack_rows([runner.load_state(st) for st in picked], "cuda")
    checked = CheckedScan(scan_mod.brace_scan, scan_mod.brace_scan_reference)
    ik.scan_mod = type("ScanHook", (), {"brace_scan": checked})
    try:
        with counts() as got:
            checked.check = True
            batch = runner.launch(batch, 8)
            torch.cuda.synchronize()
            checked.check = False
            if checked.compared == 0:
                raise AssertionError("phase 17: no brace-scan call compared")
            t0 = time.perf_counter()
            final = runner.run(batch)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
    finally:
        ik.scan_mod = scan_mod
    for st, r in zip(picked, runner.results(final)):
        host = hosts[state_key(st)]
        if r.status != vm_config.DONE or (r.output, r.inserts) != \
                (host["output"], dict(host["inserts"])):
            raise AssertionError(f"phase 17: {r} != host {host}")
    log(f"phase 17 general resume [{card}]: {n} of phase 16's states "
        f"through DeviceRunner.load_state at the bench's general VMConfig, "
        f"{checked.compared} brace-scan calls of the first launch "
        f"bit-identical to the plain version, run to DONE in {elapsed:.3f} "
        f"s, each equal to the host; ring_stats "
        f"{json.dumps(runner.ring_stats)}")

    # the device menu: Save at the second input and Quit, then a fresh run
    # that loads slot 1
    path = os.path.join(tmp, "menu.json5")
    with open(path, "w") as f:
        f.write(tp.MESH_SRC)
    host = run_host(tp.MESH_SRC, io_manager.IOManager(
        io_manager.ScriptedBackend(["u0", "v0"])), tmp)

    class MenuBackend(io_manager.ScriptedBackend):
        """The ``menu_at``-th user_input opens the menu (Esc) and waits to
        be cancelled; an empty script waits too."""
        menu_at, n_inputs, run = 0, 0, None

        async def user_input(self, prompt, default=""):
            self.n_inputs += 1
            if self.n_inputs == self.menu_at:
                self.run.toggle_menu()
                await asyncio.Event().wait()
            if not self.responses:
                await asyncio.Event().wait()
            return await super().user_input(prompt, default)

        async def select_index(self, options, description=None):
            if not self.responses:
                await asyncio.Event().wait()
            return await super().select_index(options, description)

    def menu_run(responses, menu_at, drive=None):
        loader.invalidate_cache()
        backend = MenuBackend(list(responses))
        backend.menu_at = menu_at
        run = backend.run = DeviceProgramRun(
            path, [], io_manager.IOManager(backend), device="cuda")
        out = io_mod.StringIO()

        async def main():
            task = asyncio.create_task(run.run())
            if drive is not None:
                await drive(run, backend)
            return await task
        with contextlib.redirect_stdout(out), counts() as menu:
            asyncio.run(main())
        got.update(menu)
        return run, out.getvalue()

    first, printed = menu_run(["u0", "1", "1", "slot-a", "4"], 2)
    with open(path) as f:
        saves = json5.loads(f.read())["save_states"]
    want = dict(first.runner.export_state(first.batch, 0), label="slot-a")
    if saves != first.runner.compiled.program["save_states"] or \
            saves.get("1") != want or printed != "hi;[u0!]\n":
        raise AssertionError(f"phase 17 menu: saved {saves}, printed "
                             f"{printed!r}")

    async def load_then_answer(run, backend):
        while len(backend.exchanges) < 2:
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        backend.responses.append("v0")
        run.toggle_menu()
    second, printed = menu_run(["2", "1"], 1, load_then_answer)
    if printed != host["output"].strip() + "\n":
        raise AssertionError(f"phase 17 menu: the loaded run printed "
                             f"{printed!r}, the host {host['output']!r}")
    # the plain scans are the first launch's checks
    on_main_path("phase 17", got, "brace_scan", plain=checked.compared)
    log(f"phase 17 device menu [{card}]: Save State at the second input "
        f"(slot 1, {json.dumps(saves['1'])}) and Quit printed "
        f"{'hi;[u0!]'!r}; a fresh run's Load State of slot 1 then printed "
        f"{printed.strip()!r}, as the host; {got['kernel.brace_scan']} "
        f"brace-scan launches in phase 17, M and W "
        f"{json.dumps(mw_launches(got))}")
    return {"counts": got, "max_abs_err": checked.worst}


def phase18(card: str, tmp: str, n: int = 131_072,
            n_ring: int = 4096) -> dict:
    """The general engine over a mesh: the sharded step bit for bit one
    device's at the bench's size, then a sharded ring run to DONE."""
    import torch
    import torch_programs as tp
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch._shared import io_manager, vm_config
    from interpolation_engine_tpu_torch.ops import brace_scan as scan_mod
    from interpolation_engine_tpu_torch.ops import interp_kernel as ik
    from interpolation_engine_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch, unshard)
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner

    if torch.cuda.device_count() >= 2:
        mesh, how = make_mesh(), "one shard on each card"
    else:
        mesh, how = make_mesh(devices=["cuda"] * 4), "four shards on cuda:0"
    log(f"phase 18 mesh [{card}]: {len(mesh)} shards, {how}")
    cfg = vm_config.VMConfig(**bench.GENERAL_CFG)
    runner = DeviceRunner(compile_src(bench.adventure_program()), cfg,
                          device=mesh[0])
    devices = []

    class OnDevices:
        @staticmethod
        def brace_scan(bufs, lengths):
            devices.append(bufs.device)
            return scan_mod.brace_scan(bufs, lengths)

    one = runner.make_instances(n)
    many = shard_batch(one, mesh)
    inner, times = 8, {"one": [], "sharded": []}
    ik.scan_mod = OnDevices
    try:
        for turn in (("one", "sharded"), ("sharded", "one")):
            for which in turn:
                sync_all()
                t0 = time.perf_counter()
                if which == "one":
                    one = runner.launch(one, inner)
                else:
                    many = runner.launch(many, inner)
                sync_all()
                times[which].append((time.perf_counter() - t0) / inner)
            got = unshard(many)
            for f, a, b in zip(one._fields, got, one):
                if not torch.equal(a.to(b.device), b):
                    raise AssertionError(f"phase 18: field {f} of the "
                                         f"sharded batch differs")
    finally:
        ik.scan_mod = scan_mod
    if set(devices) != set(mesh):
        raise AssertionError(f"phase 18: brace scans on {set(devices)}")
    del one, many, got

    # a sharded ring run: every instance answers its own inputs inside a
    # parallel block (the LaneRing keyed by global row)
    def answers(i):
        return io_manager.IOManager(io_manager.ScriptedBackend(
            [f"x{i}", f"y{i}"]))
    src = tp.WAIT_SRC
    ring = DeviceRunner(compile_src(src), cfg, io_factory=answers,
                        device=mesh[0])
    with counts() as ran:
        t0 = time.perf_counter()
        final = ring.run(shard_batch(ring.make_instances(n_ring), mesh))
        sync_all()
        ring_s = time.perf_counter() - t0
    ref = DeviceRunner(compile_src(src), cfg, io_factory=answers,
                       device=mesh[0])
    ref_final = ref.run(ref.make_instances(n_ring))
    got = unshard(final)
    for f, a, b in zip(got._fields, got, ref_final):
        if not torch.equal(a.to(b.device), b):
            raise AssertionError(f"phase 18: field {f} of the sharded ring "
                                 f"run differs from the unsharded run")
    res = ring.results(final)
    for i in sorted({0, 1, n_ring // 2, n_ring - 1}):
        host = run_host(src, answers(i), tmp)
        if (res[i].output, res[i].inserts) != (host["output"],
                                                dict(host["inserts"])):
            raise AssertionError(f"phase 18: instance {i}: {res[i]} != "
                                 f"host {host}")
    for i, r in enumerate(res):
        if r.status != vm_config.DONE or \
                r.output != f"a;t0;x=x{i};t1;y=y{i};z":
            raise AssertionError(f"phase 18: instance {i}: {r}")
    on_main_path("phase 18", ran, "brace_scan")

    def ms(ts):
        return " and ".join(f"{t * 1e3:.3f}" for t in ts)
    log(f"phase 18 general adventure over the mesh [{card}]: {n} "
        f"instances, 2 launches x {inner} steps, every VMBatch field "
        f"bit-identical to one device after each, brace scans on "
        f"{len(set(devices))} device(s); ms per step: one device "
        f"{ms(times['one'])}, sharded {ms(times['sharded'])}")
    log(f"phase 18 sharded ring [{card}]: parallel_wait at {n_ring} "
        f"instances, each answering its own inputs, to DONE over the mesh "
        f"in {ring_s:.3f} s, field for field the unsharded run, outputs "
        f"the host's; ring_stats {json.dumps(ring.ring_stats)}; "
        f"{ran['kernel.brace_scan']} brace-scan launches, M and W "
        f"{json.dumps(mw_launches(ran))}")
    return {"counts": ran, "ms_one": times["one"],
            "ms_sharded": times["sharded"]}


def filter_batch(n: int, L: int, every: int = 2048):
    """Phase 19's batch: n chat-shaped streams (``torch_chat.chat_stream``:
    prose, 1-4 ``<out>`` spans, a ``<think>`` block inside the first) with
    lengths drawn from 512-L bytes, padded to L; one stream in ``every``
    opens 20 spans. Returns (streams as bytes, bufs, lengths, the
    overflowing rows)."""
    import random
    import torch_chat as tc
    rng = random.Random(SEED)
    over = list(range(0, n, every))
    raws = [tc.chat_stream(i, rng.randint(512, L), rng,
                           20 if i % every == 0 else None)
            for i in range(n)]
    bufs, lengths = tc.rows(raws, L)
    return raws, bufs.cuda(), lengths.cuda(), over


def filter_bound(lengths, L: int) -> dict:
    """A filter call must read each stream's bytes within its length and
    its length, and write the extracted bytes (L a stream), the visual
    bytes (``visual_width(L)``) and the table (TABLE int32) once; it does at
    least one operation a byte it reads."""
    from interpolation_engine_tpu_torch.ops.filter_kernel import (
        TABLE, visual_width)
    n = lengths.shape[0]
    read = int(lengths.clamp(0, L).long().sum())
    return bound(read + 4 * n + n * L + n * visual_width(L) + 4 * n * TABLE,
                 read)


def service_stream() -> str:
    """The chat service's shape: one chat stream of 8 KB."""
    import random
    import torch_chat as tc
    return tc.chat_stream(7, 8192, random.Random(SEED)).decode()


def filter_times(bufs, lengths, calls: int = 10, reps: int = 50) -> dict:
    """The chat filter's times on the card, with whichever package the
    working directory holds (a parent tree's too): the kernel queued on
    phase 19's batch (``bufs``, ``lengths``) and on one 8 KB stream in
    ``host_row``'s row (16,384 bytes) (``ms``, ``row_ms``), and
    ``filter_chat_host`` on that stream (upload, launch, downloads;
    ``host_ms``), enumerating, ms a call."""
    import torch_chat as tc
    from interpolation_engine_tpu_torch.ops import filter_kernel as fk
    start, stop, hs, he = tc.STREAM_DELIMS
    kw = dict(start=start, stop=stop, hide_start=hs, hide_stop=he,
              enumerate_outputs=True)
    raw = service_stream()
    row = fk.host_row(raw, "cuda")
    # warm: the delimiters' upload and the outputs' first allocation wait
    # for the card, which would end the queue
    fk.filter_chat_text(bufs, lengths, **kw)
    fk.filter_chat_text(*row, **kw)
    ms = timed(lambda _: fk.filter_chat_text(bufs, lengths, **kw), None,
               calls, True) / calls * 1e3
    row_ms = timed(lambda _: fk.filter_chat_text(*row, **kw), None, reps,
                   True) / reps * 1e3
    fk.filter_chat_host(raw, start, stop, hs, he, True)
    t0 = time.perf_counter()
    for _ in range(reps):
        fk.filter_chat_host(raw, start, stop, hs, he, True)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    return {"ms": ms, "row_ms": row_ms, "host_ms": host_ms,
            "row_bound_ms": filter_bound(row[1], row[0].shape[1])["bound_ms"]}


def filter_parts(bufs, lengths, calls: int = 10) -> dict:
    """The chat filter kernel at phase 19's batch shape on inputs that
    leave out one part of its work at a time, ms a call queued: every
    length 0 (the padding and the table alone), passthrough (every byte
    kept, no candidate, no hide pass), the extract pass alone (no hide
    delimiters), and the whole filter."""
    import torch
    import torch_chat as tc
    from interpolation_engine_tpu_torch.ops import filter_kernel as fk
    start, stop, hs, he = tc.STREAM_DELIMS
    zero = torch.zeros_like(lengths)
    parts = {"padding": (zero, ("", "", "", "")),
             "passthrough": (lengths, ("", "", "", "")),
             "extract": (lengths, (start, stop, "", "")),
             "whole": (lengths, (start, stop, hs, he))}
    out = {}
    for name, (lens, d) in parts.items():
        kw = dict(zip(("start", "stop", "hide_start", "hide_stop"), d),
                  enumerate_outputs=True)
        fk.filter_chat_text(bufs, lens, **kw)
        out[name] = timed(lambda _: fk.filter_chat_text(bufs, lens, **kw),
                          None, calls, True) / calls * 1e3
    return out


def turn(tree: str) -> int:
    """``--turn TREE``: with the package of the checkout TREE (this one,
    or a parent's unpacked beside it), phase 13 (its checks, its ring wall
    time and the sibling's launch), phase 5's launches (the staging alone
    and the copy among them), phase 11's sharded step, phase 22, then phase
    19's batch and ``filter_times`` and ``filter_parts`` on it, then M and
    W's times on phase 21's rows at 131,072 and 4,096 (``mw_turn``), as one
    JSON line. Run on two trees in turns in one call, it compares them on
    one card."""
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    from interpolation_engine_tpu_torch.ops import build
    if not build.__file__.startswith(tree + os.sep):
        raise AssertionError(f"imported {build.__file__}, not from {tree}")
    build.load()
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        promotion = phase13(card, tmp)
    launched = adventure_launches(card)
    sharded = mesh_launches(card, phase11_mesh(card))
    chain = phase22(card)
    _, bufs, lengths, _ = filter_batch(16_384, 8192)
    times = filter_times(bufs, lengths)
    times["parts"] = filter_parts(bufs, lengths)
    del bufs, lengths
    print(json.dumps({"tree": tree, "card": card, "phase13": promotion,
                      "phase5": launched, "phase11": sharded,
                      "phase22": chain, **times, "mw": mw_turn()}))
    return 0


def phase19(card: str, tmp: str, n: int = 16_384, L: int = 8192,
            instances: int = 256) -> dict:
    """The chat filter: the kernel against its plain version and the host
    at 16,384 streams, both timed; the service's per-stream call beside
    the host's incremental filters; the chat programs through the turbo
    engine with the filter on and off, and the kernel against its plain
    version on each stream the service filtered there, at its shape."""
    import random
    import torch
    import torch_chat as tc
    from interpolation_engine_tpu_torch._shared import io_manager
    from interpolation_engine_tpu_torch.core.filters import (
        InvertedFilter, OutputFilter)
    from interpolation_engine_tpu_torch.ops import filter_kernel as fk
    from interpolation_engine_tpu_torch.vm.turbo import (
        DONE, TurboConfig, TurboEngine)

    # (a) the batch: kernel == plain version on every field of every
    # stream, 64 sampled streams == the host filters a character a call
    raws, bufs, lengths, over = filter_batch(n, L)
    start, stop, hs, he = tc.STREAM_DELIMS
    worst = 0
    for enum in (True, False):
        kw = dict(start=start, stop=stop, hide_start=hs, hide_stop=he,
                  enumerate_outputs=enum)
        got = fk.filter_chat_text(bufs, lengths, **kw)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want = fk.filter_chat_reference(bufs, lengths, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        if enum:
            t_plain = ev[0].elapsed_time(ev[1]) / 1e3
        for key in want:
            if not torch.equal(got[key], want[key]):
                rows = torch.nonzero((got[key] != want[key]).reshape(
                    n, -1).any(dim=1))[:, 0].tolist()
                raise AssertionError(f"phase 19: the kernel's {key} differs "
                                     f"from the plain version's in rows "
                                     f"{rows[:10]} (enumerate={enum})")
        worst = max(worst, max_abs_diff([got[k] for k in want],
                                        list(want.values())))
        if enum:
            main = got
        del want
    raw_spans = main["raw_n_spans"].tolist()
    if [r for r in range(n) if raw_spans[r] > fk.MAX_SPANS] != over:
        raise AssertionError("phase 19: the streams past 16 spans are not "
                             "the ones built so")
    rng = random.Random(SEED)
    sample = rng.sample([r for r in range(n) if r not in over], 64)
    t0 = time.perf_counter()
    for r in sample:
        raw = raws[r].decode("utf-8", "replace")
        if raw.encode() != raws[r]:
            raise AssertionError(f"phase 19: stream {r} is not whole UTF-8")
        want = fk._char_oracle(raw, start, stop, hs, he, True)
        if fk.decode_row(main, r) != want:
            raise AssertionError(f"phase 19: stream {r}: the kernel's result "
                                 f"is not the host filters'")
    t_sample = time.perf_counter() - t0
    with counts() as oracle:
        for r in over:
            raw = raws[r].decode("utf-8", "replace")
            if fk.filter_chat_host(raw, start, stop, hs, he, True) != \
                    fk._char_oracle(raw, start, stop, hs, he, True):
                raise AssertionError(f"phase 19: stream {r} (past 16 spans) "
                                     f"is not the host oracle's")
    if oracle["host.chat_filter"] != len(over):
        raise AssertionError("phase 19: the streams past 16 spans did not "
                             "take the host oracle")
    del main
    times = filter_times(bufs, lengths)
    t_kern = times["ms"] / 1e3
    b = filter_bound(lengths, L)
    parts = filter_parts(bufs, lengths)
    log(f"phase 19 chat filter [{card}]: {n} streams of "
        f"{int(lengths.min())}-{int(lengths.max())} bytes (mean "
        f"{float(lengths.float().mean()):.0f}) padded to {L}, visual "
        f"{fk.visual_width(L)} wide; the kernel equals the plain version "
        f"on every field of every stream (enumerating and not), {len(over)} "
        f"streams past 16 spans take the host oracle through "
        f"filter_chat_host, 64 sampled streams equal the host filters fed "
        f"a character a call ({t_sample:.1f} s); kernel {t_kern * 1e3:.5f} "
        f"ms/call queued, plain version {t_plain * 1e3:.1f} ms/call; bound "
        f"{b['bound_ms']:.5f} ms ({b['bound_by']}), the kernel at "
        f"{b['bound_ms'] / (t_kern * 1e3) * 100:.1f} % of it")
    log(f"phase 19 chat filter by part [{card}]: " + ", ".join(
        f"{name} {ms:.5f}" for name, ms in parts.items()) + " ms/call "
        "queued (padding: every length 0; passthrough: no delimiters; "
        "extract: no hide delimiters)")
    del bufs, lengths, got
    at = fk.kernel_attributes(0)
    log(f"chat_filter_kernel, a block a stream: {at['registers']} "
        f"registers, {at['local_bytes']} local bytes a thread, "
        f"{at['static_shared_bytes']} static shared bytes and "
        f"{at['threads']} threads a block, tiles of {at['tile']} bytes")

    # (a) one stream in host_row's (1, L) row, kernel == plain on every
    # field: the service's 8 KB (L = 16,384), and about 100 KB of 20 spans
    # over many tiles (L = 131,072)
    for size, spans, enums in ((8192, None, (True, False)),
                               (100_000, 20, (True,))):
        raw = tc.chat_stream(size, size, random.Random(SEED), spans)
        row = fk.host_row(raw.decode(), "cuda")
        for enum in enums:
            kw = dict(start=start, stop=stop, hide_start=hs, hide_stop=he,
                      enumerate_outputs=enum)
            got = fk.filter_chat_text(*row, **kw)
            want = fk.filter_chat_reference(*row, **kw)
            for key in want:
                if not torch.equal(got[key], want[key]):
                    raise AssertionError(
                        f"phase 19: on the (1, {row[0].shape[1]}) row the "
                        f"kernel's {key} differs from the plain version's "
                        f"(enumerate={enum})")
            worst = max(worst, max_abs_diff([got[k] for k in want],
                                            list(want.values())))
        log(f"phase 19 one stream of {int(row[1][0])} bytes in a (1, "
            f"{row[0].shape[1]}) row [{card}]: the kernel equals the plain "
            f"version on every field ({int(got['raw_n_spans'][0])} spans)")
    log(f"phase 19 the kernel alone on one 8 KB stream in a (1, 16384) row "
        f"[{card}]: {times['row_ms']:.5f} ms/call queued; bound "
        f"{times['row_bound_ms']:.6f} ms")

    # (b) the service's call on one 8 KB stream: upload, launch, download
    raw = service_stream()
    want = fk._char_oracle(raw, start, stop, hs, he, True)
    if fk.filter_chat_host(raw, start, stop, hs, he, True) != want:
        raise AssertionError("phase 19: filter_chat_host on 8 KB differs "
                             "from the host filters")
    t_call = times["host_ms"] / 1e3
    host_ms = {}
    for chunk in (1, 4):
        t0 = time.perf_counter()
        for _ in range(5):
            extract = OutputFilter(start, stop, enumerate_outputs=True)
            hide = InvertedFilter(hs, he)
            visual = "".join(hide(extract(raw[i:i + chunk]))
                             for i in range(0, len(raw), chunk))
        host_ms[chunk] = (time.perf_counter() - t0) / 5 * 1e3
        if chunk == 1 and (list(extract.outputs), visual) != want:
            raise AssertionError("phase 19: the host filters differ")
    log(f"phase 19 one 8 KB stream [{card}]: filter_chat_host (upload, "
        f"launch, download) {t_call * 1e3:.3f} ms/call; the host's "
        f"incremental filters {host_ms[1]:.3f} ms a character a call, "
        f"{host_ms[4]:.3f} ms four characters a call")

    # (c) the chat programs through the turbo engine, the filter on and off;
    # each distinct stream the service filtered is then held against the
    # plain version at the (1, L) row filter_chat_host built for it
    def buffered(i=None):
        return io_manager.IOManager(io_manager.BufferBackend())

    service_calls = {}
    real_host = fk.filter_chat_host

    def recording_host(raw, *args):
        service_calls.setdefault((raw, *args), None)
        return real_host(raw, *args)
    launches, seconds = 0, {}
    old_flag = os.environ.pop("IE_TPU_DEVICE_FILTERS", None)
    fk.filter_chat_host = recording_host
    try:
        for name in sorted(tc.CHAT_PROGRAMS):
            with tc.sse_server(chunk_size=1) as server:
                src = tc.chat_program(name, server.url)
                host = run_host(src, buffered(), tmp)
                want = (host["output"], dict(host["inserts"]))
                for flag in (True, False):
                    if flag:
                        os.environ["IE_TPU_DEVICE_FILTERS"] = "1"
                    else:
                        os.environ.pop("IE_TPU_DEVICE_FILTERS", None)
                    eng = TurboEngine(compile_src(src),
                                      TurboConfig(**tc.CHAT_SIZES),
                                      io_factory=buffered, device="cuda")
                    batch = eng.make_batch(instances)
                    requests = len(server.requests)
                    torch.cuda.synchronize()
                    with counts() as ran:
                        t0 = time.perf_counter()
                        final = eng.run(batch)
                        torch.cuda.synchronize()
                        elapsed = time.perf_counter() - t0
                    chats = len(server.requests) - requests
                    got = ran["kernel.chat_filter"]
                    if got != (chats if flag else 0):
                        raise AssertionError(
                            f"phase 19 {name}: {chats} chat calls, "
                            f"{got} filter launches")
                    on_main_path(f"phase 19 {name}", ran, "turbo_step")
                    if eng.ring_stats["escapes"]:
                        raise AssertionError(f"phase 19 {name}: escapes")
                    for i, r in enumerate(eng.results(final)):
                        if r.status != DONE or (r.output, r.inserts) != want:
                            raise AssertionError(
                                f"phase 19 {name}: instance {i} (filter "
                                f"{'on' if flag else 'off'}): {r} != {want}")
                    launches += got
                    seconds[(name, flag)] = elapsed
                    log(f"phase 19 chat program {name}, filter "
                        f"{'on' if flag else 'off'} [{card}]: {instances} "
                        f"instances DONE equal to the host, {chats} chat "
                        f"calls, {got} filter launches, "
                        f"{ran['kernel.turbo_step']} step launches, "
                        f"{elapsed:.3f} s; ring_stats "
                        f"{json.dumps(eng.ring_stats)}")
    finally:
        fk.filter_chat_host = real_host
        if old_flag is None:
            os.environ.pop("IE_TPU_DEVICE_FILTERS", None)
        else:
            os.environ["IE_TPU_DEVICE_FILTERS"] = old_flag
    widths = set()
    for raw, *delims, enum in service_calls:
        row = fk.host_row(raw, "cuda")
        widths.add(row[0].shape[1])
        kw = dict(zip(("start", "stop", "hide_start", "hide_stop"), delims),
                  enumerate_outputs=enum)
        got = fk.filter_chat_text(*row, **kw)
        want = fk.filter_chat_reference(*row, **kw)
        for key in want:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"phase 19: on the service's stream "
                                     f"{raw!r} the kernel's {key} differs "
                                     f"from the plain version's")
        worst = max(worst, max_abs_diff([got[k] for k in want],
                                        list(want.values())))
    if not service_calls:
        raise AssertionError("phase 19: the service filtered no stream")
    log(f"phase 19 the service's streams [{card}]: {len(service_calls)} "
        f"distinct streams at (1, L) for L in {sorted(widths)}, the kernel "
        f"equal to the plain version on every field")
    return {"launches": launches, "ms": t_kern * 1e3,
            "plain_ms": t_plain * 1e3, "max_abs_err": worst, **b}


# phase 20's runs of the port's bench: PERF.md's cells in order, the
# default (adventure) as the subprocess a benchmark calls
BENCH_RUNS = (
    ("spine", "turbo", {"BENCH_WORKLOAD": "spine"}),
    ("divergent", "turbo", {"BENCH_WORKLOAD": "divergent",
                            "BENCH_DIVERGENCE": "8"}),
    ("interp", "turbo", {"BENCH_WORKLOAD": "interp"}),
    ("ring", "turbo", {"BENCH_WORKLOAD": "ring", "BENCH_RING_FRAC": "0.10"}),
    ("race-io", "turbo", {"BENCH_WORKLOAD": "race-io", "BENCH_SHARDS": "2"}),
    ("adventure", "turbo", {"BENCH_WIDTH": "512", "BENCH_ELEM": "128",
                            "BENCH_OUT": "512"}),
    ("adventure", "general", {"BENCH_ENGINE": "general"}),
)


@contextlib.contextmanager
def bench_env(env: dict):
    """The environment with every BENCH_ knob unset but ``env``."""
    old = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in old:
        del os.environ[k]
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)
        os.environ.update(old)


def check_bench_line(line: dict, workload: str, engine: str,
                     n: int) -> None:
    import torch
    name = torch.cuda.get_device_name(0)
    want = (f"({n} instances, {name}, torch {engine} engine, {workload} "
            f"workload[")
    if sorted(line) != ["metric", "unit", "value", "vs_baseline"] or \
            want not in line["metric"] or not line["value"] > 0:
        raise AssertionError(f"phase 20 {workload} ({engine}): {line}")


def phase20(card: str, n: int = 131_072) -> dict:
    """The port's bench: each of PERF.md's cells in process, the kernels
    counted (a run is one call, its warm launch and its timed rounds, so
    these lines are taken while recording); the default run as ``python -m
    interpolation_engine_tpu_torch.bench``, its executed steps held to the
    plain step version's over the same launches from the same batch."""
    import torch
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import TurboEngine

    torch.cuda.synchronize()
    total = Counter()
    for workload, engine, env in BENCH_RUNS:
        with bench_env(env), counts() as got:
            t0 = time.perf_counter()
            run = bench.measure()
        total.update(got)
        check_bench_line(run.line, workload, engine, n)
        log(f"bench: {json.dumps(run.line)} ({card}; {env}, executed "
            f"{run.executed} in {run.elapsed:.3f} s, warm launch "
            f"{run.compile_s:.3f} s, the run {time.perf_counter() - t0:.1f} "
            f"s)")
    log(f"phase 20 M and W launches in the bench runs: "
        f"{json.dumps(mw_launches(total))}")
    on_main_path("phase 20", total, "turbo_step", "brace_scan")
    with bench_env({}):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "interpolation_engine_tpu_torch.bench"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"phase 20: the bench failed: {proc.stderr}")
    for note in proc.stderr.splitlines():
        if note.startswith("# "):
            log(f"bench (the default run) {note}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check_bench_line(line, "adventure", "turbo", n)
    executed = int(proc.stderr.split("# executed=")[1].split()[0])
    log(f"bench: {json.dumps(line)} ({card}; the default, "
        f"python -m interpolation_engine_tpu_torch.bench, executed "
        f"{executed}, {time.perf_counter() - t0:.1f} s in all)")
    # the plain step version from the same batch over the same launches:
    # the warm launch, then the default BENCH_ROUNDS of 8 timed ones
    src = bench.adventure_program()
    eng = TurboEngine(compile_src(src), bench._turbo_cfg("adventure"),
                      device="cuda")
    batch = eng.make_batch(n)
    turbo_step_reference(eng.tables, batch, eng.tcfg.k_steps)
    before = bench._steps(batch)
    for _ in range(8):
        turbo_step_reference(eng.tables, batch, eng.tcfg.k_steps)
    plain = bench._steps(batch) - before
    if plain != executed:
        raise AssertionError(f"phase 20: the bench executed {executed} "
                             f"steps, the plain version {plain}")
    log(f"phase 20 the default run's {executed} steps equal the plain "
        f"step version's over the same 8 launches")
    del eng, batch
    with bench_env(BENCH_RUNS[5][2]):
        wide = TurboEngine(compile_src(src), bench._turbo_cfg("adventure"),
                           device="cuda")
    log(f"phase 20 adventure at width 512: "
        f"{tile_line(wide.tables, wide.make_batch(n), wide.tcfg.tile)}")
    return {"counts": total}


MATH_NUMBERS = ("0", "1", "2", "3", "7", "9", "10", "31", "32", "99",
                "65536", "46341", "2147483647", "2147483648", "4294967295",
                "99999999999")
MATH_OPS = ("+", "-", "*", "/", "%", "**", "//")


def math_expr(rng) -> str:
    """A paren-free expression of the test generator's shapes: numbers
    (near-wrap ones too), the seven operators, unary signs, spaces, and now
    and then a fault (a trailing operator, a dot, a stray byte)."""
    parts = []
    for k in range(rng.randint(1, 6)):
        if k:
            parts.append(rng.choice(("", " ")) + rng.choice(MATH_OPS)
                         + rng.choice(("", " ")))
        parts.append(rng.choice(("", "", "", "-", "- ", "--", "+"))
                     + rng.choice(MATH_NUMBERS))
    e = "".join(parts)
    k = rng.random()
    if k < 0.05:
        e += rng.choice((" +", "*", "**"))
    elif k < 0.1:
        cut = rng.randint(0, len(e))
        e = e[:cut] + rng.choice((".", "x", ",")) + e[cut:]
    elif k < 0.12:
        e = rng.choice(("", " ", "*1"))
    return e


def wild_pattern(rng, stars: int = None) -> str:
    """0-3 stars between literal segments of up to 33 bytes; or ``stars``
    stars between short ones (a supported pattern)."""
    count = rng.randint(0, 3) if stars is None else stars
    segs = [rng.choice(("", "a", "b", "ab", "ba", "aab", "\n"))
            if stars is not None or rng.random() < 0.85 else
            "".join(rng.choice("ab") for _ in range(rng.randint(20, 33)))
            for _ in range(count + 1)]
    return "*".join(segs)


def wild_subject(rng, pattern: str, ms: int) -> str:
    """Half the subjects are the pattern's literals with filler where its
    stars are (they mostly match), half random; one in four ends in a
    newline."""
    if rng.random() < 0.5:
        s = "".join(lit + "".join(rng.choice("ab\n") for _ in range(
            rng.randint(0, 6))) for lit in pattern.split("*"))
    else:
        s = "".join(rng.choice("aab\n") for _ in range(rng.randint(0, ms)))
    if rng.random() < 0.25:
        s = s[:ms - 1] + "\n"
    return s[:ms]


def byte_rows(texts, ms: int, gen):
    """(N, ms) uint8 rows on the card with (N,) int32 lengths; past its
    length a row holds junk digits and operators from ``gen``."""
    import numpy as np
    import torch
    data = [t.encode()[:ms] for t in texts]
    bufs = np.frombuffer(b"".join(d.ljust(ms, b"\0") for d in data),
                         np.uint8).reshape(len(texts), ms)
    lens = np.fromiter((len(d) for d in data), np.int32, len(texts))
    junk = np.frombuffer(b"0123456789+-*/%,ab\n", np.uint8)[
        gen.integers(0, 19, bufs.shape)]
    bufs = np.where(np.arange(ms)[None, :] < lens[:, None], bufs, junk)
    return (torch.from_numpy(np.ascontiguousarray(bufs)).cuda(),
            torch.from_numpy(lens).cuda())


def row_bytes(lengths, ms: int) -> int:
    """The bytes of (N, ms) rows within their lengths, each row's rounded
    up to 32-byte sectors (the least the card reads from memory)."""
    lens = lengths.clamp(0, ms).long()
    return int(((lens + 31) // 32 * 32).sum())


def held_fields(what: str, got, want) -> None:
    import torch
    for name, g, w in zip(got._fields, got, want):
        if not torch.equal(g, w):
            bad = int((g != w).reshape(g.shape[0], -1).any(dim=1).sum())
            raise AssertionError(f"phase 21 {what}: field {name} differs "
                                 f"from the plain version on {bad} rows")


def mw_inputs(n: int, seed: int) -> dict:
    """Phase 21's rows at the bench's general VMConfig (MS 96, max_stars
    2), made from ``seed`` on the card: for M flat expressions and comma
    lists with a min or max a row, for W per-row patterns against their
    subjects and one shared pattern against its own. Each entry is
    (arguments, the kernel, the plain version, the bound's bytes and
    operations)."""
    import random
    import numpy as np
    import torch
    from interpolation_engine_tpu_torch import bench
    from interpolation_engine_tpu_torch.ops import match_kernel as mk
    from interpolation_engine_tpu_torch.ops import math_kernel as mak
    ms, stars = bench.GENERAL_CFG["max_str"], bench.GENERAL_CFG["max_stars"]
    rng, gen = random.Random(seed), np.random.default_rng(seed)
    out = {}
    fb, fl = byte_rows([math_expr(rng) for _ in range(n)], ms, gen)
    eb, el = byte_rows([",".join(math_expr(rng) for _ in range(
        rng.randint(1, 4))) + rng.choice(("", "", ",")) for _ in range(n)],
        ms, gen)
    want_max = torch.from_numpy(gen.integers(0, 2, n).astype(bool)).cuda()
    # each row's bytes within its length, the lengths (and want_max), the
    # outputs (8 bytes a row); an operation a byte
    out["M flat"] = ((fb, fl), mak.math_eval_kernel, mak.eval_flat_reference,
                     row_bytes(fl, ms) + nbytes((fl,)) + 8 * n,
                     int(fl.clamp(0, ms).sum()))
    out["M enumeration"] = ((eb, el, want_max), mak.math_eval_kernel,
                            mak.eval_enum_minmax_reference,
                            row_bytes(el, ms) + nbytes((el, want_max))
                            + 8 * n, int(el.clamp(0, ms).sum()))
    pats = [wild_pattern(rng) for _ in range(n)]
    pb, pl = byte_rows(pats, ms, gen)
    sb, sl = byte_rows([wild_subject(rng, p, ms) for p in pats], ms, gen)
    shared = wild_pattern(rng, stars)
    qb, ql = byte_rows([shared], ms, gen)
    tb, tl = byte_rows([wild_subject(rng, shared, ms) for _ in range(n)], ms,
                       gen)
    for label, (p_b, p_l, s_b, s_l) in (("W per-row", (pb, pl, sb, sl)),
                                        ("W shared", (qb, ql, tb, tl))):
        # the pattern rows within plen, the subject rows within slen, the
        # lengths, the outputs (2 bytes and 1 + 2 * max_stars int32 a
        # row); an operation a subject byte
        out[label] = ((p_b, p_l, s_b, s_l, stars), mk.wildcard_match_kernel,
                      mk.wildcard_match_reference,
                      row_bytes(p_l, ms) + row_bytes(s_l, ms)
                      + nbytes((p_l, s_l)) + n * (2 + 4 * (1 + 2 * stars)),
                      int(s_l.clamp(0, ms).sum()))
    return out


def mw_ms(kernel, args, calls: int = 20) -> float:
    """ms a call of the kernel, queued (``timed``), after a warm call."""
    kernel(*args)
    return timed(lambda _: kernel(*args), None, calls, True) / calls * 1e3


MW_SIZES = (131_072, 4_096)   # the bench's batch; phases 9 and 14's counts


def mw_turn() -> dict:
    """M and W's times at MW_SIZES with the package imported (``--turn``):
    each kernel first held to its plain version at 4,096 rows."""
    out = {}
    for n in MW_SIZES:
        cases = mw_inputs(n, SEED)
        out[str(n)] = {}
        for label, (args, kernel, plain, _, _) in cases.items():
            if n == MW_SIZES[-1]:
                held_fields(f"{label} at {n}", kernel(*args), plain(*args))
            out[str(n)][label] = mw_ms(kernel, args)
        del cases
    return out


def mw_attributes(card: str) -> str:
    """M and W's registers, stack bytes and shared bytes a block (at MS
    96; W per row and shared, max_stars 2 and 64)."""
    import ctypes
    from interpolation_engine_tpu_torch.ops.build import call
    out = (ctypes.c_int * 4)()
    call("math_eval_attributes", 96, out)
    parts = [f"M {out[0]} registers, {out[1]} stack bytes, {out[2]} shared "
             f"bytes a block of {out[3]}"]
    for shared, stars in ((0, 2), (1, 2), (0, 64)):
        call("wildcard_match_attributes", 96, 96, shared, stars, out)
        parts.append(f"W {'shared' if shared else 'per-row'} max_stars "
                     f"{stars}: {out[0]} registers, {out[1]} stack bytes, "
                     f"{out[2]} shared bytes")
    return f"phase 21 attributes [{card}]: " + "; ".join(parts)


def phase21(card: str) -> dict:
    """M and W alone at the bench's general VMConfig (MS 96, max_stars 2),
    at 131,072 and 4,096 rows: each kernel equal to its plain version on
    every field of every row of rows made from ``--seed``, in both modes of
    each, then timed beside its bound (the plain versions at 131,072)."""
    import torch
    from interpolation_engine_tpu_torch.ops import interp_kernel as ik
    t0 = time.perf_counter()
    log(mw_attributes(card))
    line = {}
    for n in MW_SIZES:
        cases = mw_inputs(n, SEED)
        for label, (args, kernel, plain, nb, ops) in cases.items():
            got = kernel(*args)
            held_fields(f"{label} at {n}", got, plain(*args))
            torch.cuda.synchronize()
            if label.startswith("M"):
                errs = set(got.err.unique().tolist())
                if not {ik.ERR_OK, ik.ERR_ASSERT, ik.ERR_HOST} <= errs:
                    raise AssertionError(f"phase 21 {label} at {n}: "
                                         f"outcomes {errs}")
                what = f"{int((got.err == 0).sum())} rows OK"
            else:
                ok, sup = int(got.ok.sum()), int(got.supported.sum())
                if not (0 < ok < n) or not (
                        sup == n if label == "W shared" else 0 < sup < n):
                    raise AssertionError(f"phase 21 {label} at {n}: {ok} "
                                         f"matched, {sup} supported")
                subj, slen = args[2:4]
                last = subj.gather(1, (slen - 1).clamp(0, subj.shape[1] - 1)
                                   .long()[:, None])[:, 0]
                what = (f"{ok} matched, {int((got.ok & (last == 10)).sum())}"
                        f" of them ending in a newline, {sup} supported")
            k = mw_ms(kernel, args)
            p = (timed(lambda _: plain(*args), None, 1) * 1e3
                 if n == MW_SIZES[0] else None)
            b = bound(nb, ops)
            log(f"phase 21 {label} [{card}]: {n} rows at MS 96, every field "
                f"equal to the plain version ({what}); kernel {k:.5f} "
                f"ms/call queued, " + (f"plain {p:.3f} ms/call, "
                                       if p is not None else "")
                + f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}), the "
                f"kernel at {b['bound_ms'] / k * 100:.1f} % of it")
            if n == MW_SIZES[0]:
                line[label] = {"ms": k, "plain_ms": p, **b}
        del cases
    log(f"phase 21 {time.perf_counter() - t0:.1f} s")
    return {"math": line["M flat"], "match": line["W shared"]}


def phase22(card: str, n: int = 131_072, checked: int = 2) -> dict:
    """The ``prompt-chain`` cell's shape (portbench's configuration and
    traffic): ``n`` rows resumed from the traffic's states drawn from
    ``--seed``, 2048-byte slots, T = 3, a warp a row. Its first ``checked``
    launches held bit for bit against the plain version, then its launch
    timed queued at K = 1 and 32, and the staging alone beside a copy of
    the batch and its bound. Returns its largest deviation, its time a
    launch at K = 32, and the staging's and the copy's."""
    import torch
    from portbench import run
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        WARP, launch_plan, turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_PC, C_STEPS, TurboConfig, TurboEngine)
    spec = run.load_cell("prompt-chain")
    text = run.program_text(spec["traffic"])
    tcfg = TurboConfig(**spec["config"]["turbo_config"])
    eng = TurboEngine(compile_src(text), tcfg, device="cuda")
    states = run.start_states(spec["traffic"], text, SEED)
    dealt = run.deal(torch, n, len(states), SEED).tolist()
    b0 = eng.load_batch([states[v] for v in dealt])
    plan = launch_plan(eng.tables, b0, tcfg.tile)
    if plan.lanes != WARP:
        raise AssertionError(f"phase 22: T = {plan.tile}, {plan.lanes} "
                             f"lanes a row")
    K = tcfg.k_steps
    torch.cuda.synchronize()
    kern, ref = clone(b0), clone(b0)
    worst = 0
    with counts() as got:
        for launch in range(checked):
            turbo_step(eng.tables, kern, K)
            turbo_step_reference(eng.tables, ref, K)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_diff(kern, ref))
            if worst:
                raise AssertionError(f"phase 22: kernel and plain version "
                                     f"differ after launch {launch + 1}")
    if got["turbo.warp_row_launches"] != checked:
        raise AssertionError(f"phase 22: {got['turbo.warp_row_launches']} "
                             f"of {checked} launches a warp a row")
    steps = int((kern.regs[:, C_STEPS] - b0.regs[:, C_STEPS]).long().sum())
    del kern, ref
    launch_bound = step_bound(eng.tables, b0, steps // checked)
    L = 4
    per_k = {k: timed(lambda b, k=k: turbo_step(eng.tables, b, k), clone(b0),
                      L, True) / L * 1e3 for k in (1, K)}
    # the staging alone (every row RUNNING at a pc past the program) beside
    # a copy of the batch (a clone of its tensors: the staging's bytes)
    staged = clone(b0)
    staged.regs[:, C_PC] = eng.tables.host.n_instr
    stage_ms = timed(lambda b: turbo_step(eng.tables, b, K), staged, L,
                     True) / L * 1e3
    copy_ms = timed(clone, staged, L, True) / L * 1e3
    del staged
    stage_bound = step_bound(eng.tables, b0, 0)["bound_ms"]
    log(f"phase 22 prompt-chain, {n} rows resumed from {len(states)} "
        f"states [{card}]: the first {checked} launches x {K} steps, "
        f"{got['turbo.warp_row_launches']} of them a warp a row "
        f"(turbo.warp_row_launches), bit-identical to the plain version; "
        f"kernel {per_k[K]:.3f} ms/launch at K={K}, {per_k[1]:.3f} at K=1 "
        f"(queued), the staging alone {stage_ms:.3f}, a copy of the batch "
        f"{copy_ms:.3f}, the batch read and written once and the tables "
        f"read once {stage_bound:.4f}; bound "
        f"{launch_bound['bound_ms']:.4f} ms ({launch_bound['bound_by']}), "
        f"the kernel at {launch_bound['bound_ms'] / per_k[K] * 100:.2f} % "
        f"of it; {tile_line(eng.tables, b0, tcfg.tile)}")
    log(attributes_line())
    return {"max_abs_err": worst, "ms": per_k[K], "stage_ms": stage_ms,
            "copy_ms": copy_ms}


def programs() -> dict:
    """Phase 1's programs: the bench's and the port's test programs (the
    program text only)."""
    for path in (ROOT, os.path.join(ROOT, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    from interpolation_engine_tpu_torch import bench
    import torch_programs as tp
    return {
        "spine": (bench.BENCH_PROGRAM, ("i", 600)),
        "interp": (bench.INTERP_PROGRAM, ("i", 600)),
        "ring": (bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'"),
                 None),
        "output_overflow": (tp.OUTPUT_OVERFLOW, ("i", 25)),
        "int32_overflow": (tp.INT32_OVERFLOW, None),
        "parse_digits": (tp.PARSE_DIGITS, None),
        "brace_in_hole": (tp.BRACE_IN_HOLE, None),
        "for_loop": (tp.FOR_LOOP, None),
        "newline_affix": (tp.NEWLINE_ROUTE % {"key": "he*llo"}, None),
        "int_dispatch": (tp.INT_DISPATCH, ("i", 5)),
        "delete_clear": (tp.DELETE_CLEAR, None),
        "adventure": (bench.adventure_program(), ("turn", 600)),
        "race_io": (bench.race_io_program(), ("turn", 600)),
        "list_spine": (tp.LIST_SPINE, None),
        "list_edges": (tp.LIST_EDGES, None),
        "for_dynamic": (tp.FOR_DYNAMIC, None),
        "par_wait": (tp.PAR_RACE % {"mode": "wait"}, None),
        "par_race": (tp.PAR_RACE % {"mode": "race"}, None),
        "midblock_race": (tp.MIDBLOCK_PARK % {"mode": "race"}, None),
        "parked_freeze_par": (tp.PARKED_FREEZE_PAR, None),
    }


def main(argv=None) -> int:
    global SEED
    import argparse
    parser = argparse.ArgumentParser(description="Drive the PyTorch port "
                                     "on one CUDA card and check it.")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="seed of the generated inputs (default 0)")
    parser.add_argument("--turn", metavar="TREE",
                        help="run only phase 13, the launches of phases "
                        "5, 11 and 22, the chat filter's and M and W's "
                        "times, with the package of the checkout TREE, and "
                        "print one JSON line")
    args = parser.parse_args(argv)
    SEED = args.seed
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.turn:
        return turn(args.turn)
    progs = programs()
    import torch_programs as tp
    from interpolation_engine_tpu_torch.ops import build

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    log(f"build: {build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    worst = phase1(progs)
    log(attributes_line())
    with tempfile.TemporaryDirectory() as tmp:
        phase2(card, tmp)
        phase3(card, tmp)
        phase4(tmp)
        main_path = phase5(card, tmp)
        race_io = phase6(card, tmp)
        scan_line = phase7(card)
        general = phase8(card)
        phase9(card, tmp)
        phase10(tmp, tp.NOT_TURBO)
        sharded = phase11(card, tmp)
        phase12(card, tmp, race_io)
        promoted = phase13(card, tmp)
        general_ops = phase14(card, tmp)
        escaped = phase15(card, tmp)
        t_resume = time.perf_counter()
        resumed = phase16(card, tmp)
        general_resumed = phase17(card, tmp, resumed["states"],
                                  resumed["hosts"])
        general_mesh = phase18(card, tmp)
        log(f"phases 16-18 {time.perf_counter() - t_resume:.1f} s")
        t_chat = time.perf_counter()
        chat = phase19(card, tmp)
        log(f"phase 19 {time.perf_counter() - t_chat:.1f} s")
        t_bench = time.perf_counter()
        benched = phase20(card)
        log(f"phase 20 {time.perf_counter() - t_bench:.1f} s")
        alone = phase21(card)
        chain = phase22(card)

    def launches(counter: str, *phases) -> int:
        return sum(p["counts"][counter] for p in phases)

    # the step kernel's launches on phases 5, 13, 16 and 20's main paths,
    # those that stepped a row with a warp counted apart; phase 22's
    # launches are checks and timings, its deviation counts
    paths = (main_path, promoted, resumed, benched)
    main_path.update(
        launches=launches("kernel.turbo_step", *paths),
        warp_launches=launches("turbo.warp_row_launches", *paths),
        max_abs_err=max(worst, chain["max_abs_err"],
                        *(p["max_abs_err"] for p in paths
                          if "max_abs_err" in p)))
    # the regroup: its launches on phases 5, 16 and 20's main paths, those
    # of 5 and 16 held to the plain version, the times phase 16's
    regrouped = dict(resumed["regroup"], launches=launches(
        "kernel.regroup", main_path, resumed, benched), max_abs_err=max(
        main_path.pop("regroup_max_abs_err"),
        resumed["regroup"]["max_abs_err"]))
    # the brace scan's launches on phases 8, 17, 18 and 20's general paths
    scanned = (general, general_resumed, general_mesh, benched)
    general["launches"] = launches("kernel.brace_scan", *scanned)
    general["max_abs_err"] = max(general["max_abs_err"],
                                 general_resumed["max_abs_err"])
    kernels = [
        dict(name="turbo_step_kernel", source=KERNEL_SRC,
             replaces=KERNEL_REPLACES, **main_path),
        dict(name="brace_scan_kernel", source=SCAN_SRC,
             replaces=SCAN_REPLACES, **general, **scan_line),
        dict(name="sharded_turbo_step", source=KERNEL_SRC,
             replaces=SHARDED_REPLACES, **sharded),
        dict(name="chat_filter_kernel", source=FILTER_SRC,
             replaces=FILTER_REPLACES, **chat),
        dict(name="regroup", source=REGROUP_SRC, replaces=None,
             **regrouped)]
    # M and W: their launches on phases 8, 14, 15, 17, 18 and 20's general
    # paths, every call of phases 8 and 14's first two launches held to the
    # plain version, the times phase 21's
    worst = max(general["mw_max_abs_err"], general_ops["mw_max_abs_err"])
    mw_paths = scanned + (general_ops, escaped)
    kernels += [
        dict(name="math_eval_kernel", source=MATH_SRC,
             replaces=MATH_REPLACES, max_abs_err=worst,
             launches=launches("kernel.math_eval", *mw_paths),
             **alone["math"]),
        dict(name="wildcard_match_kernel", source=MATCH_SRC,
             replaces=MATCH_REPLACES, max_abs_err=worst,
             launches=launches("kernel.wildcard_match", *mw_paths),
             **alone["match"])]
    keys = ("name", "route", "source", "replaces", "launches",
            "warp_launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # no single PyTorch call computes a VM step, the four scan values, the
    # chat filter, an expression's value or a wildcard match; the regroup's
    # plain version is one, a stable torch.sort (its library_ms)
    kernels = [{k: dict({"library_ms": None, "warp_launches": None}, **kern,
                        route="cuda")[k]
                for k in keys} for kern in kernels]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
