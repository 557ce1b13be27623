#!/usr/bin/env python3
"""Drive the PyTorch port (``interpolation_engine_tpu_torch``) on one CUDA
card and check it.

    python3 chip_smoke.py

Phases, each of which raises on any failure (the script then exits non-zero
and prints no result):

1. kernel against plain version: for the bench's spine, interp, ring,
   adventure and race-io programs and a set of scalar, list and
   parallel-lane test programs, at 8,192 instances, the CUDA step kernel and
   ``turbo_step_reference`` run the same launches on the card and must leave
   bit-identical regs, sbuf, out and meta after every launch;
2. the spine at the bench's size: 131,072 instances,
   ``TurboEngine.run_async`` to the end through the kernel; every instance
   DONE with the host engine's output; tasks/s of kernel and plain version
   over the same launches;
3. the ring: the bench's ring program with every instance parking three
   times on a canned user_input, 16,384 instances (cut from 131,072 because
   every park takes the exact per-row host path), outputs and inserts equal
   to the host engine's;
4. the CLI: ``--engine device --batch 256`` prints what the host CLI prints,
   for the spine and for the adventure program;
5. the main path, the bench's default workload at its widths: the adventure
   program (lists, a parallel race per turn) at 131,072 instances; kernel
   and plain version bit-identical over the first two launches, with both
   times; then ``run_async`` to the end at 40 turns through the kernel,
   every instance DONE with the host engine's output and inserts;
6. race-io through the lane servicing: every instance's race parks its
   input lane once per turn, 3 turns, answered "cgo"; 16,384 instances
   (cut from 131,072 as in phase 3); every park goes through the LaneRing,
   and every instance ends DONE with the host engine's output and inserts.

The last two lines of standard output are one JSON object naming each
kernel with its launches on the main path, its largest deviation from the
plain version and both times, then ``{"ok": true, "device": ...}``. Needs
one CUDA card; imports nothing of JAX.
"""

import asyncio
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SRC = "interpolation_engine_tpu_torch/csrc/turbo_step.cu"
KERNEL_REPLACES = "interpolation_engine_tpu/vm/turbo.py:1879"
SEED = 0


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


def canned_io(answer: str = "ok"):
    from interpolation_engine_tpu_torch._shared import io_manager

    class Canned(io_manager.BufferBackend):
        sync_io = True

        def user_input_sync(self, prompt, default=""):
            return answer

        async def user_input(self, prompt, default=""):
            return answer

    return io_manager.IOManager(Canned())


def clone(batch):
    return type(batch)(*(t.clone() for t in batch))


def max_abs_diff(a, b) -> int:
    return max((int((x.long() - y.long()).abs().max())
                for x, y in zip(a, b) if x.numel()), default=0)


def spread_slot(engine, batch, key: str, hi: int, gen) -> None:
    """Start each instance at its own value of int slot ``key`` so lanes
    leave their loops at different pcs and rounds."""
    import torch
    col = engine.cols.sint(engine.plan.slot_of[key])
    batch.regs[:, col] = torch.randint(
        0, hi, (batch.regs.shape[0],), generator=gen,
        dtype=torch.int32).to(batch.regs.device)


def phase1(progs: dict, n: int = 8192, launches: int = 4) -> int:
    """Kernel == plain version after every launch; returns the largest
    deviation seen (0 when bit-identical)."""
    import torch
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        TurboConfig, TurboEngine)
    worst = 0
    gen = torch.Generator().manual_seed(SEED)
    for name, (src, spread) in progs.items():
        eng = TurboEngine(compile_src(src), TurboConfig(
            width=128, out_width=192, k_steps=16), device="cuda")
        b = eng.make_batch(n)
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
            f"parked {int((status == 2).sum())})")
    return worst


def timed(fn, batch, launches: int) -> float:
    """Seconds for ``launches`` calls of fn on batch, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn(batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def phase2(card: str, tmp: str, n: int = 131_072) -> None:
    import bench
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
    t_kern = timed(lambda b: turbo_step(eng.tables, b, K), kern, L)
    t_ref = timed(lambda b: turbo_step_reference(eng.tables, b, K), ref, L)
    if max_abs_diff(kern, ref):
        raise AssertionError("phase 2: kernel and plain version differ")
    steps = int(kern.regs[:, C_STEPS].long().sum())
    del kern, ref
    log(f"phase 2 spine, first {L} launches x {K} steps at {n} instances "
        f"[{card}]: kernel {steps / t_kern:.1f} tasks/s "
        f"({t_kern / L * 1e3:.3f} ms/launch), plain version "
        f"{steps / t_ref:.1f} tasks/s ({t_ref / L * 1e3:.3f} ms/launch)")

    # the main path: run_async to the end, counted
    turbo_step.launches = 0
    turbo_step_reference.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = eng.run(b0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = turbo_step.launches
    if launches <= 0 or turbo_step_reference.launches != 0:
        raise AssertionError(
            f"phase 2: main path launched the kernel {launches} times and "
            f"the plain version {turbo_step_reference.launches} times")
    check_all_done("phase 2", eng, final, host)
    total = int(final.regs[:, C_STEPS].long().sum())
    log(f"phase 2 spine main path [{card}]: {n} instances DONE with "
        f"{want!r}, {launches} kernel launches, {total} steps in "
        f"{elapsed:.3f} s = {total / elapsed:.1f} tasks/s end to end")


def phase3(card: str, tmp: str, n: int = 16_384) -> None:
    import bench
    import torch
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STATUS, DONE, TurboConfig, TurboEngine)
    src = bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'") \
        .replace("'1073741824'", "'3'")
    host = run_host(src, canned_io(), tmp)
    eng = TurboEngine(compile_src(src), TurboConfig(
        width=128, out_width=192, k_steps=64), io_factory=lambda i:
        canned_io(), device="cuda")
    t0 = time.perf_counter()
    final = eng.run(eng.make_batch(n))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if not bool((final.regs[:, C_STATUS] == DONE).all()):
        raise AssertionError("phase 3: not every instance is DONE")
    parks = eng.ring_stats["parks"]
    if parks != 3 * n:
        raise AssertionError(f"phase 3: {parks} parks, want {3 * n}")
    want = (host["output"], dict(host["inserts"]))
    for i, r in enumerate(eng.results(final)):
        if (r.output, r.inserts) != want:
            raise AssertionError(f"phase 3: instance {i}: {r} != {want}")
    log(f"phase 3 ring [{card}]: {n} instances, {parks} parks in "
        f"{eng.ring_stats['rounds']} rounds, {elapsed:.3f} s, all DONE "
        f"with {want[0]!r}")


def phase4(tmp: str) -> None:
    import bench
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
        host = cli("interpolation_engine_tpu.cli")
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


def phase5(card: str, tmp: str, n: int = 131_072) -> dict:
    """The main path: the adventure program at the bench's widths."""
    import bench
    import torch
    from interpolation_engine_tpu_torch._shared import io_manager
    from interpolation_engine_tpu_torch.ops.turbo_step import (
        turbo_step, turbo_step_reference)
    from interpolation_engine_tpu_torch.vm.turbo import (
        C_STEPS, TurboConfig, TurboEngine)

    # bench.py's adventure config without the TPU-only tile and leaf
    tcfg = TurboConfig(width=128, out_width=128, k_steps=64, list_cap=12,
                       elem_width=32)
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
    t_kern = timed(lambda b: turbo_step(eng.tables, b, K), kern, L)
    t_ref = timed(lambda b: turbo_step_reference(eng.tables, b, K), ref, L)
    worst = max_abs_diff(kern, ref)
    if worst:
        raise AssertionError("phase 5: kernel and plain version differ")
    steps = int(kern.regs[:, C_STEPS].long().sum())
    del kern, ref, b0
    log(f"phase 5 adventure, first {L} launches x {K} steps at {n} "
        f"instances [{card}]: kernel {steps / t_kern:.1f} tasks/s "
        f"({t_kern / L * 1e3:.3f} ms/launch), plain version "
        f"{steps / t_ref:.1f} tasks/s ({t_ref / L * 1e3:.3f} ms/launch)")

    # the main path: run_async to the end at 40 turns, counted
    src = bench.adventure_program(t_max=40)
    host = run_host(src, io_manager.IOManager(io_manager.BufferBackend()),
                    tmp)
    eng = TurboEngine(compile_src(src), tcfg, device="cuda")
    batch = eng.make_batch(n)
    torch.cuda.synchronize()
    turbo_step.launches = 0
    turbo_step_reference.launches = 0
    t0 = time.perf_counter()
    final = eng.run(batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = turbo_step.launches
    if launches <= 0 or turbo_step_reference.launches != 0:
        raise AssertionError(
            f"phase 5: main path launched the kernel {launches} times and "
            f"the plain version {turbo_step_reference.launches} times")
    check_all_done("phase 5", eng, final, host)
    total = int(final.regs[:, C_STEPS].long().sum())
    log(f"phase 5 adventure main path [{card}]: {n} instances DONE with "
        f"the host's {len(host['output'].encode())}-byte output, {launches} "
        f"kernel launches, {eng.ring_stats['parks']} parks, {total} steps "
        f"in {elapsed:.3f} s = {total / elapsed:.1f} tasks/s end to end")
    return {"launches": launches, "ms": t_kern / L * 1e3,
            "plain_ms": t_ref / L * 1e3, "max_abs_err": worst}


def phase6(card: str, tmp: str, n: int = 16_384) -> None:
    """race-io: one lane park per instance per turn, through the
    LaneRing."""
    import bench
    import torch
    from interpolation_engine_tpu_torch.vm.turbo import (
        TurboConfig, TurboEngine)
    src = bench.race_io_program(t_max=3)
    host = run_host(src, canned_io("cgo"), tmp)
    eng = TurboEngine(compile_src(src), TurboConfig(
        width=128, out_width=128, k_steps=16, list_cap=12, elem_width=32),
        io_factory=lambda i: canned_io("cgo"), device="cuda")
    lanes_serviced = 0
    service = eng._service_lanes

    async def counted(*args):
        nonlocal lanes_serviced
        lanes_serviced += 1
        return await service(*args)

    eng._service_lanes = counted
    t0 = time.perf_counter()
    final = eng.run(eng.make_batch(n))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    parks = eng.ring_stats["parks"]
    if parks != 3 * n or lanes_serviced != 3 * n:
        raise AssertionError(f"phase 6: {parks} parks, {lanes_serviced} "
                             f"through the lane servicing, want {3 * n}")
    check_all_done("phase 6", eng, final, host)
    want = (host["output"], dict(host["inserts"]))
    for i, r in enumerate(eng.results(final)):
        if (r.output, r.inserts) != want:
            raise AssertionError(f"phase 6: instance {i}: {r} != {want}")
    log(f"phase 6 race-io ring [{card}]: {n} instances, {parks} lane parks "
        f"in {eng.ring_stats['rounds']} rounds, ring wall time "
        f"{elapsed:.3f} s, all DONE with {want[0]!r}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import bench
    import torch_programs as tp
    from interpolation_engine_tpu_torch.ops import build

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.load()
    log(f"build: {build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s")

    progs = {
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
    worst = phase1(progs)
    with tempfile.TemporaryDirectory() as tmp:
        phase2(card, tmp)
        phase3(card, tmp)
        phase4(tmp)
        main_path = phase5(card, tmp)
        phase6(card, tmp)
    print(json.dumps({"kernels": [{
        "name": "turbo_step_kernel", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "launches": main_path["launches"],
        "max_abs_err": max(worst, main_path["max_abs_err"]),
        "ms": main_path["ms"], "plain_ms": main_path["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
