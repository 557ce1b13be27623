"""The port's bench: batched VM tasks/s on one CUDA card.

    python -m interpolation_engine_tpu_torch.bench

The counterpart of the JAX package's root ``bench.py``, with its programs,
its workloads, its environment knobs and its output: the last line of
standard output is one JSON object, ``{"metric", "value", "unit",
"vs_baseline"}``, and standard error carries the same ``# executed=...``,
ring and interpolation bytes/s lines. It runs in one process, on
``BENCH_DEVICE`` (``cuda`` unless the caller asks for ``cpu``); without a
card it fails, and it never falls back to the CPU.

Workloads (``BENCH_WORKLOAD``): ``adventure`` (the default), ``spine``,
``divergent`` (the adventure from ``BENCH_DIVERGENCE`` states at spread
order indexes), ``interp``, ``ring`` (``BENCH_RING_FRAC`` of the instances
park every loop iteration on a canned backend) and ``race-io`` (a lane park
a turn in every instance, on ``BENCH_SHARDS`` sibling engines). Engines
(``BENCH_ENGINE``): ``turbo`` (the default) and ``general``; ``ring`` and
``race-io`` always run the turbo engine, and the metric names the engine
that ran. The JAX bench's other knobs (``BENCH_INSTANCES``,
``BENCH_ROUNDS``, ``BENCH_ROOMS``, ``BENCH_WIDTH``, ``BENCH_OUT``,
``BENCH_ELEM``, ``BENCH_LIST_CAP``, ``BENCH_INNER_STEPS``, ``BENCH_INTERP``,
``BENCH_INTERP_ITERS``) are read as it reads them. Its Mosaic and
compile-budget knobs (``REFUSED``) have no meaning here: a run that sets
one fails and names it. A base config whose one instance does not fit a
block's shared memory fails with ``NotTurbo``; the bench does not switch
engines.

Task accounting is the JAX bench's: the sum of the per-instance step
counters (``C_STEPS``) over the timed launches, over the wall time to a
synchronise. Where the two benches count differently:

- race-io: the port's fast park path counts as its exact ring does, 47
  steps an instance at 3 turns, where the JAX fast path counts 44 (it
  resumes a drained race at its join without the lane's thread end).
- divergent: the JAX kernel steps each tile at its lanes' minimum pc; the
  port steps each instance at its own pc. So the same launches carry more
  steps in the port, and the two numbers do not measure the same quantity.
- a launch of the port runs ``k_steps`` VM steps an instance. A JAX launch
  runs ``k_steps`` iterations of its dispatch, and each runs every branch
  of one leaf of ``leaf`` instructions in order, so a lane may retire
  several instructions an iteration. Tasks are instructions in both, but a
  JAX launch at the JAX bench's ``leaf`` carries more of them.
"""

import asyncio
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from ._shared import (compile_program, io_manager, json5, loader, validator,
                      vm_config)
from .ops import interp_kernel as ik
from .vm import state as vs
from .vm.driver import DeviceRunner
from .vm.turbo import (C_STEPS, TurboConfig, TurboEngine, assign_shard_ids,
                       make_shard_engines, run_pipelined)

# the north-star target the JAX bench's vs_baseline is measured against
TARGET_TASKS_PER_SEC = 10_000_000.0

BENCH_PROGRAM = """
{
    default_state: {order_index: 1, inserts: {i: 0, acc: 0, word: 'spin'}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'set', item:'state-{i}', output_name:'tag'},
        {cmd:'math', input:'{acc} + {i} % 7', output_name:'acc'},
        {cmd:'goto_map', text:'{word}-{i}', target_maps:[
            {'spin-512': '@end'},
            {'spin-*': '@loop'},
            {'*': '@loop'},
        ]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'done acc={acc}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# the interp workload: a loop whose work is rendering multi-hole templates
# through the turbo engine; its bytes are counted from the program below
INTERP_PROGRAM = """
{
    default_state: {order_index: 1, inserts:
        {i: 0, who: 'traveler', place: 'the tower of dawn'}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'set', item:'You are {who} at {place} on turn {i}',
         output_name:'line'},
        {cmd:'set', item:'{line} -- and {who} studies {place} once more',
         output_name:'line2'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'1073741824': '@end'}, {'*': '@loop'}]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'{line2}'},
    ],
    named_tasks: {}, save_states: {},
}
"""

# an iteration is 5 steps (label, math, set, set, goto_map) and renders
# line (46 literal bytes and the digits of {i}, taken as 3) and line2
# (line and 52 literal bytes)
INTERP_TASKS_PER_ITER = 5
INTERP_BYTES_PER_ITER = (46 + 3) + (46 + 3 + 52)


RING_PROGRAM = """
{
    default_state: {order_index: 1, inserts: {i: 0, acc: 0, sel: 'spin'}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'goto_map', text:'{sel}', target_maps:[
            {'park': '@ask'}, {'*': '@skip'}]},
        {cmd:'label', name:'@ask'},
        {cmd:'user_input', prompt:'? ', output_name:'ans'},
        {cmd:'label', name:'@skip'},
        {cmd:'math', input:'{acc} + {i} % 7', output_name:'acc'},
        {cmd:'set', item:'s-{i}', output_name:'tag'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'1073741824': '@end'}, {'*': '@loop'}]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'done {acc}'},
    ],
    named_tasks: {}, save_states: {},
}
"""


def race_io_program(n_rooms: int = 6, t_max: int = 1 << 30,
                    trim: int = 10) -> str:
    """The adventure spine with the reference flagship's real blocking
    shape (examples/text_adventure.json5:66-198): every turn races a
    compute "generation" lane against a BLOCKING user_input lane. The
    compute lane wins; the input lane's park is serviced at race
    cancellation (one ring park per instance per turn)."""
    rooms = []
    for r in range(n_rooms):
        nr = (r + 1) % n_rooms
        nr2 = (r + 3) % n_rooms
        rooms.append("""
        {cmd:'label', name:'@room-%(r)d'},
        {cmd:'clear'},
        {cmd:'math', input:'{turn} + 1', output_name:'turn'},
        {cmd:'set', item:'scene-%(r)d-{turn}', output_name:'scene'},
        {cmd:'list_append', list:'{hist}', item:'h%(r)d.{turn}',
         output_name:'hist'},
        {cmd:'math', input:'length(hist)', output_name:'hlen'},
        {cmd:'goto_map', text:'{hlen}', target_maps:[
            {'%(trim)d': '@trim-%(r)d'}, {'*': '@play-%(r)d'}]},
        {cmd:'label', name:'@trim-%(r)d'},
        {cmd:'list_slice', list:'{hist}', from_index:5,
         to_index:'{hlen}', output_name:'hist'},
        {cmd:'label', name:'@play-%(r)d'},
        {cmd:'parallel_race', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'gen-{scene}', output_name:'gen'},
                {cmd:'print', text:'{gen};'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'user_input', prompt:'> ', output_name:'choice'},
            ]},
        ]},
        {cmd:'math', input:'{acc} + {turn} %% 7', output_name:'acc'},
        {cmd:'goto_map', text:'{turn}', target_maps:[
            {'%(tmax)d': '@fin'}, {'*': '@hop-%(r)d'}]},
        {cmd:'label', name:'@hop-%(r)d'},
        {cmd:'goto_map', text:'{choice}-{hlen}', target_maps:[
            {'c%(r)d-3': '@room-%(nr2)d'},
            {'c*': '@room-%(nr)d'},
            {'*': '@fin'}]},
        """ % {"r": r, "nr": nr, "nr2": nr2, "tmax": t_max,
               "trim": trim})
    return """
    {
        default_state: {order_index: 1, inserts:
            {turn: 0, acc: 0, hist: ['seed'], choice: 'c0'}},
        order: [
            %s
            {cmd:'label', name:'@fin'},
            {cmd:'print', text:'fin turn={turn} '},
            {cmd:'print', text:'acc={acc} '},
            {cmd:'print', text:'hist={hist}'},
        ],
        named_tasks: {}, save_states: {},
    }
    """ % "".join(rooms)


def adventure_program(n_rooms: int = 6, t_max: int = 1 << 30,
                      trim: int = 10) -> str:
    """A text_adventure-shaped pure-compute spine: per room — history list
    append + length + trim-slice (the summarization window of
    text_adventure.json5:290-324), a parallel_race of a "generation" lane
    vs a "choice" lane (:66-198), goto_map dispatch to the next room.
    n_rooms=6 → ~120 instructions. Terminates at turn t_max."""
    rooms = []
    for r in range(n_rooms):
        nr = (r + 1) % n_rooms
        nr2 = (r + 3) % n_rooms
        rooms.append("""
        {cmd:'label', name:'@room-%(r)d'},
        {cmd:'clear'},
        {cmd:'math', input:'{turn} + 1', output_name:'turn'},
        {cmd:'set', item:'scene-%(r)d-{turn}', output_name:'scene'},
        {cmd:'list_append', list:'{hist}', item:'h%(r)d.{turn}',
         output_name:'hist'},
        {cmd:'math', input:'length(hist)', output_name:'hlen'},
        {cmd:'goto_map', text:'{hlen}', target_maps:[
            {'%(trim)d': '@trim-%(r)d'}, {'*': '@play-%(r)d'}]},
        {cmd:'label', name:'@trim-%(r)d'},
        {cmd:'list_slice', list:'{hist}', from_index:5,
         to_index:'{hlen}', output_name:'hist'},
        {cmd:'label', name:'@play-%(r)d'},
        {cmd:'parallel_race', tasks:[
            {cmd:'serial', tasks:[
                {cmd:'set', item:'gen-{scene}', output_name:'gen'},
                {cmd:'print', text:'{gen};'},
            ]},
            {cmd:'serial', tasks:[
                {cmd:'set', item:'c%(r)d', output_name:'choice'},
            ]},
        ]},
        {cmd:'math', input:'{acc} + {turn} %% 7', output_name:'acc'},
        {cmd:'goto_map', text:'{turn}', target_maps:[
            {'%(tmax)d': '@fin'}, {'*': '@hop-%(r)d'}]},
        {cmd:'label', name:'@hop-%(r)d'},
        {cmd:'goto_map', text:'{choice}-{hlen}', target_maps:[
            {'c%(r)d-3': '@room-%(nr2)d'},
            {'c*': '@room-%(nr)d'},
            {'*': '@fin'}]},
        """ % {"r": r, "nr": nr, "nr2": nr2, "tmax": t_max,
               "trim": trim})
    return """
    {
        default_state: {order_index: 1, inserts:
            {turn: 0, acc: 0, hist: ['seed'], choice: 'c0'}},
        order: [
            %s
            {cmd:'label', name:'@fin'},
            {cmd:'print', text:'fin turn={turn} '},
            {cmd:'print', text:'acc={acc} '},
            {cmd:'print', text:'hist={hist}'},
        ],
        named_tasks: {}, save_states: {},
    }
    """ % "".join(rooms)


# knobs of the JAX bench that exist for Mosaic, its compile budget or its
# CPU fallback, none of which the port has
REFUSED = ("BENCH_TILE", "BENCH_LEAF", "BENCH_COLD_GUARD",
           "BENCH_COMPILE_BUDGET_S", "BENCH_FORCE_CPU")
WORKLOADS = ("adventure", "spine", "divergent", "interp", "ring", "race-io")
ENGINES = ("turbo", "general")
# the general engine's VMConfig (the JAX bench's _measure_general)
GENERAL_CFG = dict(max_str=96, max_key=24, n_slots=12, arena_size=1024,
                   pool_size=32, out_size=192, max_subst=6, max_stars=2,
                   max_list=16, max_fix=4)
# the interpolation bytes/s probe (the JAX bench's _measure_interp_bytes)
INTERP_CFG = dict(max_str=256, max_key=24, n_slots=12, arena_size=1024,
                  pool_size=16, out_size=128, max_subst=8, max_stars=2,
                  max_list=8, max_fix=4)
INTERP_INSERTS = {"who": "traveler", "scene": "the tower of dawn",
                  "turn": 12847}
INTERP_TEMPLATE = ("You are {who} at {scene} on turn {turn}; "
                   "{who} studies {scene} again.")


class Measured(NamedTuple):
    line: dict          # the JSON line
    executed: int       # VM steps of the timed launches
    elapsed: float      # their wall seconds, to a synchronise
    compile_s: float    # the engine's build (the kernel library's first
    #                     build and load) and the warm launch, seconds


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _turbo_cfg(workload: str) -> TurboConfig:
    """The TurboConfig each workload measures with (the JAX bench's, read
    from the same knobs, with the port's own tile)."""
    if workload == "race-io":
        # a park every ~14 steps: K = 16 keeps a launch near the cadence
        return TurboConfig(
            width=_env_int("BENCH_WIDTH", 128),
            out_width=_env_int("BENCH_OUT", 128),
            k_steps=_env_int("BENCH_INNER_STEPS", 16),
            list_cap=_env_int("BENCH_LIST_CAP", 12),
            elem_width=_env_int("BENCH_ELEM", 32))
    if workload == "ring":
        return TurboConfig(width=128, out_width=192,
                           k_steps=_env_int("BENCH_INNER_STEPS", 64))
    return TurboConfig(
        width=_env_int("BENCH_WIDTH", 128),
        out_width=_env_int("BENCH_OUT", 128),
        k_steps=_env_int("BENCH_INNER_STEPS", 64),
        list_cap=_env_int("BENCH_LIST_CAP", 12),
        elem_width=_env_int("BENCH_ELEM", 32))


def _device() -> torch.device:
    name = os.environ.get("BENCH_DEVICE", "cuda")
    if name not in ("cuda", "cpu"):
        raise SystemExit(f"bench: BENCH_DEVICE={name!r}: cuda or cpu")
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (BENCH_DEVICE=cpu runs the "
                         "plain versions on the CPU)")
    return torch.device(name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _steps(batch) -> int:
    return int(batch.regs[:, C_STEPS].sum(dtype=torch.int64))


def _source(workload: str) -> str:
    if workload == "spine":
        return BENCH_PROGRAM
    if workload == "interp":
        return INTERP_PROGRAM
    if workload == "ring":
        return RING_PROGRAM
    cap = _env_int("BENCH_LIST_CAP", 12)
    make = race_io_program if workload == "race-io" else adventure_program
    return make(_env_int("BENCH_ROOMS", 6), trim=min(10, cap - 2))


def compile_src(src: str):
    program = json5.loads(loader.add_line_numbers(src))
    validator.validate_program(program)
    return compile_program(program)


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi failed: {e}"


def measure() -> Measured:
    """One bench run as the environment asks; prints the JAX bench's
    stderr lines and returns the JSON line with the run's counts."""
    for knob in REFUSED:
        if knob in os.environ:
            raise SystemExit(f"bench: {knob} is a knob of the JAX bench "
                             f"(Mosaic, its compile budget or its CPU "
                             f"fallback) that the port does not have")
    device = _device()
    workload = os.environ.get("BENCH_WORKLOAD", "adventure")
    engine = os.environ.get("BENCH_ENGINE", "turbo")
    if workload not in WORKLOADS or engine not in ENGINES:
        raise SystemExit(f"bench: BENCH_WORKLOAD={workload!r}, "
                         f"BENCH_ENGINE={engine!r}: the workloads are "
                         f"{WORKLOADS}, the engines {ENGINES}")
    on_card = device.type == "cuda"
    n_instances = _env_int("BENCH_INSTANCES", 131_072 if on_card else 2_048)
    rounds = _env_int("BENCH_ROUNDS", 8)
    compiled = compile_src(_source(workload))
    if compiled.host_only:
        raise SystemExit(f"bench: the {workload} program is host-only")
    divergence = _env_int("BENCH_DIVERGENCE",
                          8 if workload == "divergent" else 0)
    if workload == "ring":
        executed, elapsed, compile_s = _measure_ring(
            compiled, n_instances, rounds, device)
    elif workload == "race-io":
        executed, elapsed, compile_s = _measure_race_io(
            compiled, n_instances, rounds, device)
    elif engine == "turbo":
        executed, elapsed, compile_s = _measure_turbo(
            compiled, n_instances, rounds, device, workload, divergence)
    else:
        executed, elapsed, compile_s = _measure_general(
            compiled, n_instances, rounds, device)
    ran = "turbo" if workload in ("ring", "race-io") else engine

    tasks_per_sec = executed / elapsed
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    line = {
        "metric": (f"batched VM tasks/sec ({n_instances} instances, {name}, "
                   f"torch {ran} engine, {workload} workload"
                   f"[{compiled.n_instr} instrs])"),
        "value": round(tasks_per_sec, 1),
        "unit": "tasks/sec",
        "vs_baseline": round(tasks_per_sec / TARGET_TASKS_PER_SEC, 4),
    }
    log(f"# executed={executed} elapsed={elapsed:.3f}s "
        f"compile={compile_s:.1f}s platform={device.type}")
    if workload == "interp":
        bps = (executed / INTERP_TASKS_PER_ITER
               * INTERP_BYTES_PER_ITER / elapsed)
        log(f"# interpolation_bytes_per_sec_turbo={bps:.3e}")
    if os.environ.get("BENCH_INTERP", "1") != "0":
        bps = _measure_interp_bytes(min(n_instances, 32_768), device)
        log(f"# interpolation_bytes_per_sec_general_kernel={bps:.3e}")
    if on_card:
        log(f"# card: {_card_line()}")
    return Measured(line, executed, elapsed, compile_s)


def interp_probe(n: int, device):
    """The interpolation probe's batch: one template over n rows of one
    store. Returns ``render()``, one pass of ``ops/interp_kernel.py``
    ``interpolate`` over it (the brace-scan kernel on a card)."""
    cfg = vm_config.VMConfig(**INTERP_CFG)
    batch = vs.broadcast_row(
        vs.encode_instance(INTERP_INSERTS, cfg, pc=0, rng=1), n, device)
    data = INTERP_TEMPLATE.encode("utf-8")
    row = torch.zeros((1, cfg.max_str), dtype=torch.uint8)
    row[0, :len(data)] = torch.tensor(list(data), dtype=torch.uint8)
    buf = row.to(device).expand(n, cfg.max_str).contiguous()
    return lambda: ik.interpolate(batch, buf, len(data), cfg)


def _measure_interp_bytes(n: int, device) -> float:
    """Rendered bytes/s through the general engine's interpolation over
    the probe's batch, on the headline's device."""
    render = interp_probe(n, device)
    res = render()                              # the warm pass
    if bool((res.err != ik.ERR_OK).any()):
        raise RuntimeError("bench: the interpolation probe's rows failed")
    per_pass = int(res.length.sum(dtype=torch.int64))
    iters = _env_int("BENCH_INTERP_ITERS", 3)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        res = render()
    _sync(device)
    return per_pass * iters / (time.perf_counter() - t0)


def divergent_states(compiled, slot_of, n: int, divergence: int) -> list:
    """The JAX bench's divergent batch: n states of the default inserts and
    every key the adventure reads (those the plan has a slot for), at
    ``divergence`` top-level order indexes spread over the order."""
    inserts = dict(compiled.program["default_state"]["inserts"])
    extra = {"scene": "s", "gen": "g", "hlen": 1}
    inserts.update({k: v for k, v in extra.items() if k in slot_of})
    n_top = len(compiled.program["order"])
    targets = [1 + (k * n_top) // divergence for k in range(divergence)]
    return [{"inserts": dict(inserts), "output": "",
             "order_index": targets[i % divergence]}
            for i in range(n)]


def _measure_turbo(compiled, n, rounds, device, workload, divergence=0):
    """The turbo engine: one warm launch, then ``rounds`` launches of
    k_steps VM steps each."""
    t0 = time.perf_counter()
    eng = TurboEngine(compiled, _turbo_cfg(workload), device=device)
    build_s = time.perf_counter() - t0
    t_enc = time.perf_counter()
    if divergence > 0:
        batch = eng.load_batch(divergent_states(
            compiled, eng.plan.slot_of, n, divergence))
        what = "load_batch"
    else:
        batch = eng.make_batch(n)
        what = "make_batch"
    _sync(device)
    log(f"# {what}(encode+transfer)={time.perf_counter() - t_enc:.1f}s")
    step = eng.step_fn(n)

    t0 = time.perf_counter()
    batch = step(batch)
    _sync(device)
    compile_s = build_s + time.perf_counter() - t0

    steps0 = _steps(batch)
    t0 = time.perf_counter()
    for _ in range(rounds):
        batch = step(batch)
    _sync(device)
    elapsed = time.perf_counter() - t0
    return _steps(batch) - steps0, elapsed, compile_s


class _Canned(io_manager.BufferBackend):
    """A backend that answers every user_input at once with ``answer``."""
    sync_io = True

    def __init__(self, answer: str):
        super().__init__()
        self.answer = answer

    def user_input_sync(self, prompt, default=""):
        return self.answer

    async def user_input(self, prompt, default=""):
        return self.answer


def ring_states(compiled, n: int, frac: float) -> list:
    """The JAX bench's ring batch: one instance in 1 / frac at ``sel:
    'park'``, the rest spinning."""
    inserts = dict(compiled.program["default_state"]["inserts"])
    states = []
    for i in range(n):
        ins = dict(inserts)
        if i % max(int(1 / max(frac, 1e-9)), 1) == 0:
            ins["sel"] = "park"
        states.append({"inserts": ins, "output": "", "order_index": 1})
    return states


def _measure_ring(compiled, n, rounds, device):
    """Ring pressure: BENCH_RING_FRAC of the instances park on a canned
    user_input every loop iteration; ``rounds`` ring rounds timed, with the
    ring's share of the wall time on stderr."""
    frac = float(os.environ.get("BENCH_RING_FRAC", 0.10))
    t0 = time.perf_counter()
    eng = TurboEngine(compiled, _turbo_cfg("ring"), device=device,
                      io_factory=lambda i: io_manager.IOManager(
                          _Canned("ok")))
    build_s = time.perf_counter() - t0
    batch = eng.load_batch(ring_states(compiled, n, frac))
    step = eng.step_fn(n)

    t0 = time.perf_counter()
    batch = step(batch)
    _sync(device)
    compile_s = build_s + time.perf_counter() - t0

    steps0 = _steps(batch)
    t0 = time.perf_counter()
    batch = asyncio.run(eng.run_async(batch, max_rounds=rounds))
    _sync(device)
    elapsed = time.perf_counter() - t0
    rs = eng.ring_stats
    log(f"# ring: rounds={rs['rounds']} parks={rs['parks']} "
        f"fast={rs['fast_parks']} "
        f"ring_ms={rs['ring_ms']:.1f} "
        f"ring_share={rs['ring_ms'] / max(elapsed * 1e3, 1e-9):.3f}")
    return _steps(batch) - steps0, elapsed, compile_s


def _measure_race_io(compiled, n, rounds, device):
    """Every instance parks its race's user_input lane every turn, on
    BENCH_SHARDS sibling engines pipelined on one event loop: one warm
    launch and one warm ring round, then ``rounds`` ring rounds timed. No
    instance may leave the batch (promotion or escape)."""
    shards = max(1, _env_int("BENCH_SHARDS", 2))
    ns = n // shards
    t0 = time.perf_counter()
    engines = make_shard_engines(
        compiled, _turbo_cfg("race-io"), shards, device=device,
        io_factory=lambda i: io_manager.IOManager(_Canned("cgo")))
    build_s = time.perf_counter() - t0
    assign_shard_ids(engines, ns)
    batches = [e.make_batch(ns) for e in engines]
    step = engines[0].step_fn(ns)

    t0 = time.perf_counter()
    batches = [step(b) for b in batches]
    _sync(device)
    compile_s = build_s + time.perf_counter() - t0
    batches = asyncio.run(run_pipelined(list(zip(engines, batches)),
                                        max_rounds=1))

    steps0 = sum(_steps(b) for b in batches)
    rs0 = [dict(e.ring_stats) for e in engines]
    t0 = time.perf_counter()
    batches = asyncio.run(run_pipelined(list(zip(engines, batches)),
                                        max_rounds=rounds))
    _sync(device)
    elapsed = time.perf_counter() - t0
    steps1 = sum(_steps(b) for b in batches)
    for e in engines:
        if e._escape_results or e._promote_states or e._escape_states:
            raise RuntimeError("bench: race-io must stay fully batched")

    def delta(key):
        return sum(e.ring_stats[key] - r0[key]
                   for e, r0 in zip(engines, rs0))
    ring_ms = delta("ring_ms")
    log(f"# race-io ring: shards={shards} "
        f"rounds={engines[0].ring_stats['rounds']} "
        f"parks={delta('parks')} fast={delta('fast_parks')} "
        f"ring_ms={ring_ms:.1f} "
        f"ring_share={ring_ms / max(elapsed * 1e3, 1e-9):.3f}")
    return steps1 - steps0, elapsed, compile_s


def _measure_general(compiled, n, rounds, device):
    """The general engine: one warm launch, then ``rounds`` launches of
    BENCH_INNER_STEPS steps from the fresh batch, with no ring."""
    inner_steps = _env_int("BENCH_INNER_STEPS", 8)
    t0 = time.perf_counter()
    runner = DeviceRunner(compiled, vm_config.VMConfig(**GENERAL_CFG),
                          device=device)
    build_s = time.perf_counter() - t0
    batch = runner.make_instances(n)

    t0 = time.perf_counter()
    runner.launch(batch, inner_steps)
    _sync(device)
    compile_s = build_s + time.perf_counter() - t0

    state = batch
    before = int(state.steps.sum(dtype=torch.int64))
    t0 = time.perf_counter()
    for _ in range(rounds):
        state = runner.launch(state, inner_steps)
    _sync(device)
    elapsed = time.perf_counter() - t0
    return (int(state.steps.sum(dtype=torch.int64)) - before, elapsed,
            compile_s)


def main() -> int:
    print(json.dumps(measure().line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
