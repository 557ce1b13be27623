"""Run one cell of the port's benchmark once.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found
by name: ``BENCHMARK.json``'s ``workloads`` entry names a
``configs/<config>.json`` and a ``traffic/<traffic>.json``, and each
metric has a ``metrics/<name>.json``: an end-to-end metric's names the
harness's reading that it reports, a per-layer metric's its reader. A
run:

1. loads the kernel library (``ops/build.py`` builds it once per checkout
   under the port's ``_build/``), compiles the traffic's program and
   builds the configuration's engine;
2. makes the batch on the card, each row resuming from one of the
   traffic's start states, drawn and dealt from ``--seed``, and warms it
   up with one launch of the configuration's ``warm_steps``;
3. with ``--trace 1``, runs ``trace_rounds`` rounds under
   ``torch.profiler`` for the per-layer metrics;
4. measures for ``--seconds``: rounds back to back, a CUDA event after
   each; it waits only on the event ``lag_rounds`` back, to read the host
   clock, so the card's queue never drains;
5. checks every row: its steps and status, and that it still equals the
   first row that resumed from the same state; and a sample of rows,
   drawn from the seed, against the plain reference (``reference.py``)
   run from each row's own state;
6. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
   ``checks``, each number compared beside its limit (also the last lines
   of standard error).

It needs as many CUDA cards as the cell asks for, and fails without
them. It reads and writes nothing outside its checkout but the port's
kernel build under ``interpolation_engine_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import importlib
import itertools
import json
import os
import random
import string
import sys
import time
from pathlib import Path

from portbench import metrics, reference

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "interpolation_engine_tpu")
SAMPLE_SEED_SALT = 0x5EED


def process_start() -> float:
    """When this process started, in seconds of ``CLOCK_BOOTTIME``."""
    with open("/proc/self/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def since_start() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - process_start()


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole: ``interpolation_engine_tpu_torch`` is not
    ``interpolation_engine_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# ---- the cell's files ------------------------------------------------------

def load_cell(name: str, bench: Path = BENCHMARK, data: Path = HERE) -> dict:
    """The cell named ``name`` with its configuration, traffic and the
    per-layer metrics it reports, each read from its own file."""
    spec = json.loads(bench.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[name]

    def read(kind: str, key: str) -> dict:
        return json.loads((data / kind / f"{key}.json").read_text())

    return {
        "cell": cell,
        "config": read("configs", cell["config"]),
        "traffic": read("traffic", cell["traffic"]),
        "end_to_end": [dict(read("metrics", m["name"]), **m)
                       for m in spec["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [dict(read("metrics", m["name"]), **m)
                      for m in spec["per_layer"]
                      if name in m.get("workloads", [name])],
    }


def draw(spec: dict, rng: random.Random, env: dict):
    """One insert value from its traffic spec: ``{"int": [lo, hi]}``,
    ``{"word": n}`` (n lowercase letters), ``{"ref": name}`` (a
    stratum's or an earlier insert's value), ``{"format": template}``
    (over those) or ``{"list": spec, "len": name}``."""
    if "int" in spec:
        return rng.randrange(*spec["int"])
    if "word" in spec:
        return "".join(rng.choice(string.ascii_lowercase)
                       for _ in range(spec["word"]))
    if "ref" in spec:
        return env[spec["ref"]]
    if "format" in spec:
        return spec["format"].format(**env)
    if "list" in spec:
        return [draw(spec["list"], rng, env)
                for _ in range(env[spec["len"]])]
    raise ValueError(f"unknown insert spec {spec!r}")


def program_text(traffic: dict) -> str:
    gen = importlib.import_module(f"portbench.programs.{traffic['program']}")
    return gen.source(**traffic["params"])


def start_states(traffic: dict, text: str, seed: int) -> list:
    """The distinct saved states the traffic's instances resume from:
    ``variants_per_stratum`` for each combination of the ``strata``, in
    the same order for every seed, their inserts drawn from the seed;
    each resumes at the top-level task as many tasks after the label
    ``start["label"]`` (a template) as the stratum ``start["after"]``
    says."""
    labels = reference.Machine(text).labels
    names = list(traffic["strata"])
    strata = list(itertools.product(*traffic["strata"].values()))
    rng = random.Random(seed)
    states = []
    for k in range(len(strata) * traffic["variants_per_stratum"]):
        env = dict(zip(names, strata[k % len(strata)]))
        inserts = {}
        for key, spec in traffic["inserts"].items():
            inserts[key] = env[key] = draw(spec, rng, env)
        start = traffic["start"]
        states.append({"inserts": inserts, "output": "", "order_index":
                       labels[start["label"].format(**env)] + 1
                       + env[start["after"]]})
    return states


def deal(torch, n: int, n_states: int, seed: int):
    """Which state each of ``n`` rows resumes from: a permutation of the
    rows drawn from the seed, modulo the number of states, through a
    permutation of the states, so every seed gives each state ``n //
    n_states`` rows or one more, in another order, and a small batch
    draws its states from all of them."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randperm(n, generator=g) % n_states
    return torch.randperm(n_states, generator=g)[rows]


# ---- the engines -----------------------------------------------------------

class Engine:
    """What the harness drives and reads of one engine. ``deal_rows``
    gives it the start states and the state of each row; ``since_make``
    is the VM steps each row has taken since its batch was made;
    ``episodes`` the finished episodes' counts and sampled rows."""

    round_steps = 1
    episode_steps = None

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.since_make = 0
        self.sample = []
        self.episodes = []
        self.done = 0

    def deal_rows(self, states: list, variant) -> None:
        """``variant`` (n,), on the host: the state each row resumes
        from. ``twin`` is the first row that resumes from the same state;
        a sound step keeps the two equal."""
        torch = self.torch
        n = variant.shape[0]
        first = torch.full((len(states),), n, dtype=torch.int64)
        first.scatter_reduce_(0, variant, torch.arange(n), "amin")
        self.states, self.variant = states, variant
        self.twin = first[variant].to(self.device)

    def make(self, n: int):
        self.n, self.since_make = n, 0
        return self._make(n)

    def round(self, batch):
        if self.since_make == self.episode_steps:
            self.episodes.append(self.snapshot(batch))
            self.done = self.done + self.row_steps(batch).sum(
                dtype=self.torch.int64)
            batch = self.make(self.n)
        batch = self._launch(batch, self.round_steps)
        self.since_make += self.round_steps
        return batch

    def warm(self, batch, steps: int):
        """One launch of ``steps`` steps, the cell's own shapes."""
        batch = self._launch(batch, steps)
        self.since_make += steps
        return batch

    def work(self, batch) -> int:
        """Every VM step the engine's counters show, over all episodes."""
        return int(self.done + self.row_steps(batch).sum(
            dtype=self.torch.int64))

    def failed(self, batch, steps: int):
        """Rows that stopped, or took other than ``steps`` steps."""
        from interpolation_engine_tpu_torch._shared import vm_config
        return ((self.row_steps(batch) != steps)
                | (self.row_status(batch) != vm_config.RUNNING)).sum(
                    dtype=self.torch.int64)

    def exports(self, rows) -> list:
        return rows

    def snapshot(self, batch) -> tuple:
        """A batch's counts and sampled rows, kept on the card without a
        host sync: (steps, failed, unlike their twin, sampled rows)."""
        return (self.since_make, self.failed(batch, self.since_make),
                self.rows_unlike_twin(batch).sum(dtype=self.torch.int64),
                self.rows(batch, self.sample))


class Turbo(Engine):
    """The turbo engine: a round is one launch of ``k_steps`` steps."""

    def __init__(self, compiled, config: dict, torch, device):
        super().__init__(torch, device)
        from interpolation_engine_tpu_torch.vm import turbo
        self.mod = turbo
        self.cfg = turbo.TurboConfig(**config["turbo_config"])
        self.eng = turbo.TurboEngine(compiled, self.cfg, device=device)
        self.round_steps = self.cfg.k_steps

    def _make(self, n: int):
        self.step = self.eng.step_fn(n)
        return self.eng.load_batch([self.states[v]
                                    for v in self.variant.tolist()])

    def _launch(self, batch, steps: int):
        if steps % self.round_steps:
            raise ValueError(f"{steps} steps is not a whole number of "
                             f"launches of {self.round_steps}")
        for _ in range(steps // self.round_steps):
            batch = self.step(batch)
        return batch

    def row_steps(self, batch):
        return batch.regs[:, self.mod.C_STEPS]

    def row_status(self, batch):
        return batch.regs[:, self.mod.C_STATUS]

    def rows_unlike_twin(self, batch):
        """Rows whose registers, slots, output or list planes differ from
        their twin's (regs and out are (n, ...); sbuf and meta (R, n,
        ...))."""
        regs, sbuf, out, meta = batch
        t = self.twin
        return ((regs != regs[t]).any(1) | (out != out[t]).any(1)
                | (sbuf != sbuf[:, t]).any(2).any(0)
                | (meta != meta[:, t]).any(2).any(0))

    def rows(self, batch, rows: list) -> list:
        return [self.eng.export_state(batch, i) for i in rows]

    def bound_ctx(self, batch) -> dict:
        t = self.eng.tables
        return {"batch": list(batch), "tables": [t.flat, t.lits],
                "launch_steps": self.round_steps * batch.regs.shape[0]}


class General(Engine):
    """The general engine: a round is one step (its one host sync); a
    batch runs ``episode_steps`` steps, then the rows resume from their
    start states again (the arena and pool free nothing until the host
    ring re-encodes a row, and this cell runs no ring)."""

    def __init__(self, compiled, config: dict, torch, device):
        super().__init__(torch, device)
        from interpolation_engine_tpu_torch._shared import vm_config
        from interpolation_engine_tpu_torch.vm import driver, state
        self.state = state
        self.runner = driver.DeviceRunner(
            compiled, vm_config.VMConfig(**config["vm_config"]),
            device=device)
        self.episode_steps = config["episode_steps"]
        self.starts = None
        if config["warm_steps"] > self.episode_steps:
            raise ValueError("warm_steps past episode_steps")

    def _make(self, n: int):
        """The start states encoded once, then each row a copy of its
        own, made on the card; each row its own PRNG stream, as
        ``make_instances`` gives."""
        torch = self.torch
        if self.starts is None:
            self.starts = self.state.stack_rows(
                [self.runner.load_state(s) for s in self.states],
                self.device)
            self.take = self.variant.to(self.device)
        batch = self.starts.take(self.take)
        return batch._replace(rng=torch.arange(
            1, n + 1, dtype=torch.int64, device=self.device))

    def _launch(self, batch, steps: int):
        return self.runner.launch(batch, steps)

    def row_steps(self, batch):
        return batch.steps

    def row_status(self, batch):
        return batch.status

    def rows_unlike_twin(self, batch):
        """Rows any of whose fields differ from their twin's, but for
        ``rng``: each row has its own stream."""
        n = batch.pc.shape[0]
        unlike = None
        for name in self.state.FIELDS:
            if name == "rng":
                continue
            t = getattr(batch, name).reshape(n, -1)
            d = (t != t[self.twin]).any(1)
            unlike = d if unlike is None else unlike | d
        return unlike

    def rows(self, batch, rows: list):
        """The rows as a small batch of their own, still on the card;
        ``exports`` reads it."""
        idx = self.torch.tensor(rows, device=batch.pc.device)
        return batch.take(idx)

    def exports(self, rows) -> list:
        if isinstance(rows, list):
            return rows
        return [self.runner.export_state(rows, j)
                for j in range(rows.pc.shape[0])]

    def bound_ctx(self, batch) -> dict:
        return {}


ENGINES = {"turbo": Turbo, "general": General}


# ---- one run ---------------------------------------------------------------

class Clock:
    """Round ends: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.marks = [self.mark()]

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, lag: int) -> None:
        """Wait for the round ``lag`` rounds back to have ended."""
        if self.cuda and len(self.marks) > lag:
            self.marks[-1 - lag].synchronize()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def rounds_ms(self) -> list:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def now_us() -> float:
    """The clock ``torch.profiler`` stamps its events with."""
    return time.time_ns() / 1e3


def run_rounds(torch, device, engine, batch, lag: int, *, seconds=None,
               rounds=None, spans=None):
    """Rounds back to back until ``seconds`` of host clock or ``rounds``
    rounds have passed, then a synchronise. Returns the batch, the clock
    of the rounds' ends and the wall seconds. ``spans``, a list, gets
    ``(name, False, start_us, end_us)`` for each launch, clock read and
    synchronise."""
    def span(name, start):
        if spans is not None:
            spans.append((metrics.SPAN_PREFIX + name, False, start,
                          now_us()))

    clock = Clock(torch, device)
    t0 = time.perf_counter()
    while True:
        t = now_us()
        batch = engine.round(batch)
        span("launch", t)
        t = now_us()
        clock.marks.append(clock.mark())
        span("clock", t)
        t = now_us()
        clock.wait(lag)
        span("sync", t)
        done = len(clock.marks) - 1
        if rounds is not None and done >= rounds:
            break
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
    t = now_us()
    clock.sync()
    span("sync", t)
    return batch, clock, time.perf_counter() - t0


def kineto_events(prof):
    """The profiler's raw events as ``(name, on_device, start_us,
    end_us)``: reading them raw skips ``events()``'s tree of Python
    objects, which takes minutes on a long trace."""
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        yield (ev.name(), str(ev.device_type()).rsplit(".", 1)[-1] != "CPU",
               start, start + ev.duration_ns() / 1e3)


def check(engine, batch, text: str, control_bits=None) -> dict:
    """The numbers compared, each with its limit, over every episode the
    run made and the batch it ends with: rows that stopped or stepped
    other than the reference, rows unlike their twin, and sampled rows
    whose exported state differs from the reference's, run from the
    row's own start state. ``control_bits`` puts the reference at that
    integer width in the program's place (the control)."""
    def reference_state(v: int, steps: int, bits: int = 32) -> dict:
        key = (v, steps, bits)
        if key not in memo:
            memo[key] = reference.Machine(
                text, bits, state=engine.states[v]).run(steps).export()
        return memo[key]

    memo: dict = {}
    failed = unlike = bad = 0
    for steps, f, u, rows in [*engine.episodes, engine.snapshot(batch)]:
        failed, unlike = failed + int(f), unlike + int(u)
        for row, got in zip(engine.sample, engine.exports(rows)):
            v = int(engine.variant[row])
            if control_bits:
                got = reference_state(v, steps, control_bits)
            bad += got != reference_state(v, steps)
    return {"rows_failed": {"value": failed, "limit": 0},
            "rows_unlike_twin": {"value": unlike, "limit": 0},
            "sample_unlike_reference": {"value": bad, "limit": 0}}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device=None, instances=None, control_bits=None,
             bench: Path = BENCHMARK, data: Path = HERE) -> dict:
    """One run of cell ``name``; returns the result line. ``device`` and
    ``instances`` let the tests run it on the CPU at a small batch;
    ``control_bits`` judges the control in the program's place (``check``),
    which the benchmark's own runs never do."""
    spec = load_cell(name, bench, data)
    cfg, traffic = spec["config"], spec["traffic"]
    t_entry = since_start()
    import torch
    if device is None:
        chips = spec["cell"]["chips"]
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise SystemExit(f"portbench: cell {name} needs {chips} CUDA "
                             f"card(s); this machine has "
                             f"{torch.cuda.device_count()}")
        device = "cuda"
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    n = instances or cfg["instances"]

    t_torch = since_start()
    t0 = time.perf_counter()
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader, validator)
    if cuda:
        from interpolation_engine_tpu_torch.ops import build
        build.load()
    text = program_text(traffic)
    program = json5.loads(loader.add_line_numbers(text))
    validator.validate_program(program)
    compiled = compile_program(program)
    engine = ENGINES[cfg["engine"]](compiled, cfg, torch, device)
    spans = {"setup.engine": time.perf_counter() - t0}

    states = start_states(traffic, text, seed)
    engine.deal_rows(states, deal(torch, n, len(states), seed))
    rng = random.Random(seed ^ SAMPLE_SEED_SALT)
    engine.sample = sorted(rng.sample(range(n), min(cfg["check_rows"], n)))
    batch = engine.make(n)
    Clock(torch, device).sync()
    t_made = since_start()
    batch = engine.warm(batch, cfg["warm_steps"])
    Clock(torch, device).sync()
    t_warm = since_start()

    profile = None
    if trace:
        # on a card only the device's operations and the CUDA runtime's
        # calls are traced: recording every host operation as well would
        # slow the host-bound general step by half
        act = torch.profiler.ProfilerActivity
        with torch.profiler.profile(
                activities=[act.CUDA if cuda else act.CPU]) as prof:
            # two rounds untraced while the profiler's buffers fill
            batch, _, _ = run_rounds(torch, device, engine, batch,
                                     cfg["lag_rounds"], rounds=2)
            spans_host: list = []
            window = now_us()
            batch, _, _ = run_rounds(torch, device, engine, batch,
                                     cfg["lag_rounds"],
                                     rounds=cfg["trace_rounds"],
                                     spans=spans_host)
            window = (window, now_us())
        profile = metrics.read_profile(
            [*kineto_events(prof), *spans_host], window,
            cfg["trace_rounds"], engine.round_steps)

    setup_s = since_start()
    before = engine.work(batch)
    batch, clock, wall = run_rounds(torch, device, engine, batch,
                                    cfg["lag_rounds"], seconds=seconds)
    work = engine.work(batch) - before
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    rounds_ms = clock.rounds_ms()

    loaded = forbidden_modules()
    if loaded:
        raise SystemExit(f"portbench: {loaded} loaded in the run's "
                         f"process; the benchmark runs the port alone")

    t_check = time.perf_counter()
    checks = check(engine, batch, text, control_bits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"# {name}: set-up to the harness {t_entry:.2f} s, torch and "
          f"the card {t_torch - t_entry:.2f} s, setup.engine "
          f"{spans['setup.engine']:.2f} s, batch "
          f"{t_made - t_torch - spans['setup.engine']:.2f} s, warm "
          f"{t_warm - t_made:.2f} s; {len(rounds_ms)} rounds in "
          f"{wall:.3f} s (ms: first {[round(r, 3) for r in rounds_ms[:3]]}"
          f", median {sorted(rounds_ms)[len(rounds_ms) // 2]:.3f}, most "
          f"{max(rounds_ms):.3f}), {len(engine.episodes)} episodes "
          f"ended; check "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)

    if trace:
        ctx = {"spans": spans, "rounds_ms": rounds_ms,
               **engine.bound_ctx(batch)}
        values = metrics.per_layer(spec["per_layer"], profile, ctx)
    else:
        readings = {"tasks_per_s": metrics.rate(work, wall),
                    "round_p95_ms": metrics.p95(rounds_ms),
                    "setup_s": setup_s}
        values = {m["name"]: {"value": readings[m["reading"]],
                              "unit": m["unit"]}
                  for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if trace:
        dev["busy_s"] = metrics.busy_us(profile) / 1e6
        dev["window_s"] = profile.window_us / 1e6
    line = {"correct": correct, "attempted": n,
            "failed": checks["rows_failed"]["value"], "metrics": values,
            "device": dev}
    if trace:
        line["breakdown"] = metrics.breakdown(profile)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    line = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    for key, c in line["checks"].items():
        print(f"check {key} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
