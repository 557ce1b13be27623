"""The port's span and counter recorder (``core/events.py``'s ``EVENTS.span``,
``count`` and ``recording``) on the general step and the turbo engine's
``load_batch`` and launch, on the CPU: off it records nothing and changes
nothing; on, its spans nest as the step does, its counters count what the
step did, and its clock is ``time.time_ns``'s. The turbo launch's order
(``ops/turbo_step.py`` ``launch_order``) counts its regroups, and only
while recording reads back its warps' start pcs. Each tile plan counts its
T and where its literals stay, each launch on a card the bytes it stages
and whether a warp steps each row, and the entry the base width it sizes
for a program."""

import ast
import dataclasses
import pathlib
import threading
import time

import pytest
import torch

from interpolation_engine_tpu_torch._shared import (compile_program, json5,
                                                     loader, validator,
                                                     vm_config)
from interpolation_engine_tpu_torch.core import events
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm import state as vs
from interpolation_engine_tpu_torch.vm import syncs
from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
from interpolation_engine_tpu_torch.vm.turbo import TurboConfig, TurboEngine

# a loop of ten instructions: rows resumed at different tasks sit at
# different pcs, so a step runs several groups, and the handlers reach the
# syncs of set, list_slice's bounds, print and delete
PROGRAM = """
{
    default_state: {order_index: 1, inserts:
        {n: 0, s: 'a', hist: ['x'], key: 'k1'}},
    order: [
        {cmd:'label', name:'@top'},
        {cmd:'math', input:'{n} + 1', output_name:'n'},
        {cmd:'set', item:'v-{n}-{s}', output_name:'s'},
        {cmd:'list_append', list:'{hist}', item:'h{n}', output_name:'hist'},
        {cmd:'list_slice', list:'{hist}', from_index:1, to_index:4,
         output_name:'hist'},
        {cmd:'math', input:'length(hist)', output_name:'m'},
        {cmd:'print', text:'{s};'},
        {cmd:'set', item:'{n}', output_name:'tmp'},
        {cmd:'delete', wildcards:['tm*']},
        {cmd:'goto_map', text:'{key}', target_maps:[{'k*': '@top'}]},
    ],
    named_tasks: {}, save_states: {},
}
"""
CFG = vm_config.VMConfig(max_str=96, max_key=24, n_slots=12, arena_size=1024,
                         pool_size=32, out_size=192, max_subst=6, max_stars=2,
                         max_list=16, max_fix=4)
STATE = {"inserts": {"n": 0, "s": "a", "hist": ["x"], "key": "k1"},
         "output": ""}
TASKS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 1, 3, 5]   # the task each row resumes at
STEPS = 12
GENERAL = ("general.op.", "general.gather", "general.scatter",
           "general.sync")


def compiled():
    program = json5.loads(loader.add_line_numbers(PROGRAM))
    validator.validate_program(program)
    return compile_program(program)


@pytest.fixture(scope="module")
def runner():
    return DeviceRunner(compiled(), CFG, device="cpu")


def start(runner) -> vs.VMBatch:
    return vs.stack_rows([runner.load_state(dict(STATE, order_index=t))
                          for t in TASKS])


@pytest.fixture(scope="module")
def recorded(runner):
    """Each step's recording and the distinct pcs of its RUNNING rows,
    read apart from the step."""
    batch, steps = start(runner), []
    for _ in range(STEPS):
        running = batch.status == vm_config.RUNNING
        pcs = set(batch.pc[running].tolist())
        with EVENTS.recording() as rec:
            batch = runner.step.step(batch)
        steps.append((rec, pcs))
    return steps


def test_off_records_nothing_and_on_changes_nothing(runner):
    assert EVENTS.recorded is None
    assert EVENTS.span("general.step") is EVENTS.span("turbo.launch")
    EVENTS.count("general.groups", 3)
    assert EVENTS.recorded is None
    off = runner.launch(start(runner), STEPS)
    with EVENTS.recording() as rec:
        on = runner.launch(start(runner), STEPS)
    assert EVENTS.recorded is None
    assert rec.spans and rec.counters
    assert len(set(off.pc.tolist())) > 1
    for name in vs.FIELDS:
        assert torch.equal(getattr(off, name), getattr(on, name)), name


def test_groups_are_the_distinct_running_pcs(recorded):
    assert any(len(pcs) > 1 for _, pcs in recorded)
    for rec, pcs in recorded:
        assert rec.counters["general.groups"] == len(pcs)


@pytest.mark.parametrize("kind", GENERAL)
def test_spans_nest_in_a_step_of_their_thread(recorded, kind):
    seen = 0
    for rec, _ in recorded:
        steps = [s for s in rec.spans if s[0] == "general.step"]
        assert len(steps) == 1
        for name, tid, t0, t1 in rec.spans:
            if name.startswith(kind):
                seen += 1
                assert t0 <= t1
                assert any(tid == st and s0 <= t0 and t1 <= s1
                           for _, st, s0, s1 in steps), name
    assert seen


def test_every_sync_is_counted_once(recorded):
    for rec, _ in recorded:
        n = sum(s[0] == syncs.SPAN for s in rec.spans)
        assert n >= 2      # the pc read: the unique and its read back
        assert rec.counters[syncs.COUNTER] == n


def test_handlers_are_named_by_opcode(recorded, runner):
    from interpolation_engine_tpu_torch._shared import isa
    names = {s[0] for rec, _ in recorded for s in rec.spans
             if s[0].startswith("general.op.")}
    assert {"general.op.list_append", "general.op.delete",
            "general.op.goto_map_lit"} <= names
    assert set(runner.step.op_spans.values()) == {
        "general.op." + n for n in isa.OP_NAMES.values()}


@pytest.fixture(scope="module")
def turbo():
    return TurboEngine(compiled(), TurboConfig(
        tile=8, width=64, out_width=192, k_steps=4), device="cpu")


def test_load_batch_and_launch_spans(turbo):
    states = [dict(STATE, order_index=t) for t in TASKS]
    with EVENTS.recording() as rec:
        for _ in range(3):
            batch = turbo.load_batch(states)
        step = turbo.step_fn(len(states))
        for _ in range(2):
            batch = step(batch)
    names = [s[0] for s in rec.spans]
    assert names.count("turbo.load_batch") == 3
    assert names.count("turbo.launch") == 2


@pytest.fixture
def sync_calls(monkeypatch):
    """The launch order's calls of ``host_sync``, made as before."""
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn)
        return syncs.host_sync(fn, *args, **kw)
    monkeypatch.setattr(ts, "host_sync", counted)
    return calls


def test_the_launch_order_counts_only_as_it_should(turbo, sync_calls):
    """The regroup once a regrouped launch (on the CPU its plain version,
    ``plain.regroup``); ``turbo.warps`` and
    ``turbo.warp_pcs`` (read back through ``host_sync``) on every launch
    while recording; with the recorder off, no read back at all. Twelve
    rows at 4 a block are 3 blocks: over one SM's wave of
    ``BLOCKS_PER_SM`` = 2, under two SMs'."""
    batch = turbo.load_batch([dict(STATE, order_index=t) for t in TASKS])
    n_instr = turbo.tables.host.n_instr
    order = ts.launch_order(turbo.tables, batch.regs, 4, sms=1)
    assert order is not None and not sync_calls
    assert ts.launch_order(turbo.tables, batch.regs, 4, sms=2) is None
    assert EVENTS.recorded is None and not sync_calls
    for sms, regrouped in ((1, True), (2, False)):
        with EVENTS.recording() as rec:
            got = ts.launch_order(turbo.tables, batch.regs, 4, sms=sms)
        want = ts.warp_starts(batch.regs, n_instr, 4, got).tolist()
        assert rec.counters == dict(
            {"turbo.warps": want[0], "turbo.warp_pcs": want[1],
             syncs.COUNTER: 1},
            **({"plain.regroup": 1} if regrouped else {}))
        assert [s[0] for s in rec.spans] == [syncs.SPAN]
    assert len(sync_calls) == 2
    # rows at 10 pcs, 3 warps: row order starts them at more pcs a warp
    row_order = ts.warp_starts(batch.regs, n_instr, 4).tolist()
    grouped = ts.warp_starts(batch.regs, n_instr, 4, order).tolist()
    assert row_order[0] == grouped[0] == 3
    assert grouped[1] < row_order[1]


def test_a_span_is_on_the_time_ns_clock(turbo):
    states = [dict(STATE, order_index=t) for t in TASKS]
    with EVENTS.recording() as rec:
        before = time.time_ns() / 1e3
        turbo.load_batch(states)
        after = time.time_ns() / 1e3
    (name, tid, t0, t1), = rec.spans
    assert tid == threading.get_ident()
    assert before <= t0 <= t1 <= after
    a, t, b = time.time_ns() / 1e3, events.now_us(), time.time_ns() / 1e3
    assert a <= t <= b


def test_recording_is_one_at_a_time_and_ends_on_error():
    with EVENTS.recording() as rec:
        with pytest.raises(RuntimeError):
            with EVENTS.recording():
                pass
        EVENTS.count("c")
        EVENTS.count("c", 4)
        with EVENTS.span("outer"):
            with EVENTS.span("inner"):
                pass
    assert rec.counters == {"c": 5}
    assert [s[0] for s in rec.spans] == ["inner", "outer"]
    with pytest.raises(ValueError):
        with EVENTS.recording():
            raise ValueError
    assert EVENTS.recorded is None


ROOT = pathlib.Path(__file__).resolve().parent.parent / \
    "interpolation_engine_tpu_torch"
# the modules of the general step's path on a card
SYNC_MODULES = ["vm/step.py", "vm/state.py", "vm/bytestr.py",
                "ops/interp_kernel.py", "ops/math_kernel.py",
                "ops/match_kernel.py", "ops/brace_scan.py"]
READS_BACK = {"nonzero", "tolist", "item", "unique", "cpu", "numpy"}
# functions off the step's path on a card: the plain versions
# (``*_reference``) and what only they call, the step's constructor and
# the batch's host codecs
OFF_THE_PATH = {"_put", "__init__", "from_numpy", "to_numpy"}


def syncs_outside_host_sync(tree) -> list:
    """Calls that wait on the card and are not made through
    ``host_sync``: a read back (``READS_BACK``, numpy's own aside), a
    tensor built from host data on a device (``torch.tensor`` or
    ``as_tensor`` with ``device=``), a host array moved there
    (``torch.from_numpy(...).to(...)``). A boolean mask used as an index
    is not seen here: the card's sync debug mode finds those."""
    wrapped, bare = set(), []

    def is_sync(node) -> bool:
        if isinstance(node, ast.Attribute):
            return node.attr in READS_BACK and \
                getattr(node.value, "id", None) != "np"
        if not isinstance(node, ast.Call):
            return False
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("tensor",
                                                       "as_tensor"):
            return any(k.arg == "device" for k in node.keywords)
        return isinstance(f, ast.Attribute) and f.attr == "to" and \
            isinstance(f.value, ast.Call) and \
            getattr(f.value.func, "attr", None) == "from_numpy"

    def visit(node, func):
        if isinstance(node, ast.FunctionDef):
            func = node.name
            if func.endswith("_reference") or func in OFF_THE_PATH:
                return
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "host_sync":
            wrapped.update(id(n) for a in node.args[:2]
                           for n in ast.walk(a))
        if is_sync(node) and id(node) not in wrapped:
            bare.append((func, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, "")
    return bare


# the turbo launch's path on a card (ops/turbo_step.py)
TURBO_LAUNCH = {"turbo_step", "_check", "launch_plan", "tile_plan",
                "sm_count", "regroups", "launch_order", "regroup",
                "_regroup_key", "warp_starts", "staged_bytes",
                "staged_word_bytes", "_state_regions"}


def test_the_turbo_launch_syncs_only_through_host_sync():
    """No call on the turbo launch's path waits on the card outside
    ``host_sync`` (the launch order's read back while recording)."""
    tree = ast.parse((ROOT / "ops/turbo_step.py").read_text())
    funcs = [node for node in tree.body if isinstance(node, ast.FunctionDef)
             and node.name in TURBO_LAUNCH]
    assert {f.name for f in funcs} == TURBO_LAUNCH
    bare = syncs_outside_host_sync(ast.Module(body=funcs, type_ignores=[]))
    assert not bare, f"syncs outside host_sync: {bare}"


@pytest.mark.parametrize("rel", SYNC_MODULES)
def test_every_sync_call_goes_through_host_sync(rel):
    """No call that waits on the card sits on the general step's path
    outside ``host_sync``, so the counter cannot miss a new one."""
    bare = syncs_outside_host_sync(ast.parse((ROOT / rel).read_text()))
    assert not bare, f"{rel}: syncs outside host_sync: {bare}"


def test_the_sync_scan_sees_each_kind():
    src = """
def f(t, dev):
    a = t.nonzero()
    b = torch.tensor([1], device=dev)
    c = torch.from_numpy(x).to(dev)
    d = host_sync(torch.nonzero, t)
    e = host_sync(torch.Tensor.to, torch.from_numpy(x), dev)
    g = torch.tensor([1])
    h = np.unique(x)
def f_reference(t):
    return t.tolist()
"""
    assert [ln for _, ln in syncs_outside_host_sync(ast.parse(src))] == [
        3, 4, 5]


# ---- the wide-row counters: the tile, the literals, the staged bytes and
# the base width the entry sizes ---------------------------------------------

@pytest.fixture(scope="module")
def wide():
    """The prompt-chain program's engine at the widths the entry sizes
    for it (2048-byte slots) and 12 of its rows."""
    from portbench import run
    from portbench.programs import prompt_chain
    from interpolation_engine_tpu_torch.vm.turbo import base_config
    from interpolation_engine_tpu_torch._shared import planner
    text = prompt_chain.source()
    program = json5.loads(loader.add_line_numbers(text))
    validator.validate_program(program)
    plan = planner.plan_turbo(compile_program(program))
    eng = TurboEngine(plan.compiled, base_config(plan), device="cpu",
                      plan=plan)
    traffic = dict(run.load_cell("prompt-chain")["traffic"],
                   strata={"room": [0, 1], "at": [1, 5], "hlen": [3, 9]},
                   variants_per_stratum=1)
    states = run.start_states(traffic, text, 5)
    return eng, eng.load_batch(states + states[:4])


@pytest.fixture
def h100(monkeypatch):
    """``launch_plan`` sizes its tiles for an H100's shared memory."""
    monkeypatch.setattr(ts, "shared_memory", lambda device: ts.H100_SHARED)


@pytest.mark.parametrize("which", ["wide", "narrow"])
def test_a_plan_counts_its_tile_and_where_its_literals_stay(
        which, wide, turbo, h100):
    """``turbo.tile_rows`` (T) and ``turbo.lits_in_device`` once for each
    plan ``launch_plan`` makes, not for a plan it keeps: at 2048-byte
    slots T = 3 and the literals stay in device memory; at 64 they are
    staged."""
    if which == "wide":
        eng, batch = wide
        want_t, want_lits = 3, 1
    else:
        eng = turbo
        batch = turbo.load_batch([dict(STATE, order_index=t)
                                  for t in TASKS])
        want_t, want_lits = 8, 0
    eng.tables.plans.clear()
    with EVENTS.recording() as rec:
        plan = ts.launch_plan(eng.tables, batch, eng.tcfg.tile)
        assert ts.launch_plan(eng.tables, batch, eng.tcfg.tile) is plan
    assert plan == ts.tile_plan(eng.tables, batch, eng.tcfg.tile,
                                ts.H100_SHARED)
    assert (plan.tile, int(plan.lits_off < 0)) == (want_t, want_lits)
    assert rec.counters == {"turbo.tile_rows": want_t,
                            "turbo.lits_in_device": want_lits}
    assert not rec.spans


def test_a_plan_made_with_the_recorder_off_counts_nothing(wide, h100):
    eng, batch = wide
    eng.tables.plans.clear()
    ts.launch_plan(eng.tables, batch, eng.tcfg.tile)
    assert EVENTS.recorded is None
    with EVENTS.recording() as rec:
        ts.launch_plan(eng.tables, batch, eng.tcfg.tile)
    assert rec.counters == {}


def test_staged_bytes_are_every_row_in_and_back_out(wide, turbo):
    """Host arithmetic from the plan and the shapes: the batch's bytes
    twice (regs, meta planes, string rows, output), nothing read back."""
    for eng, batch in (wide, (turbo, turbo.make_batch(12))):
        plan = ts.tile_plan(eng.tables, batch, eng.tcfg.tile,
                            ts.H100_SHARED)
        want = 2 * sum(t.numel() * t.element_size() for t in batch)
        assert ts.staged_bytes(plan, batch) == want


def test_the_wide_batch_is_29328_bytes_an_instance(wide):
    eng, batch = wide
    plan = ts.tile_plan(eng.tables, batch, eng.tcfg.tile, ts.H100_SHARED)
    assert ts.staged_bytes(plan, batch) == 2 * 12 * 29_328


@pytest.mark.parametrize("n,want", [(40, None), (129, 512), (600, 2048)])
def test_the_entry_counts_the_base_width_it_sizes(tmp_path, capsys, n,
                                                   want):
    """``run_program_on_device`` without ``tcfg`` on a program whose
    longest literal is n bytes: ``turbo.base_width`` once where it widens
    the config, and the launches on the turbo engine; a program within 128
    bytes counts no width."""
    from interpolation_engine_tpu_torch._shared import io_manager
    from interpolation_engine_tpu_torch.vm.driver import (
        run_program_on_device)
    path = tmp_path / "p.json5"
    path.write_text("""
{
    default_state: {order_index: 1, inserts: {}},
    order: [{cmd:'print', text:'%s'}],
    named_tasks: {}, save_states: {},
}
""" % ("x" * n))
    io = io_manager.IOManager(io_manager.BufferBackend())
    with EVENTS.recording() as rec:
        assert run_program_on_device(str(path), [], io, batch=2,
                                     device="cpu") == 0
    assert capsys.readouterr().out == "x" * n + "\n"
    assert rec.counters.get("turbo.base_width") == want
    assert any(s[0] == "turbo.launch" for s in rec.spans)


@pytest.mark.cuda
def test_a_launch_on_the_card_counts_its_staged_bytes(wide):
    """On a card: ``turbo.staged_bytes`` once a ``turbo_step`` launch while
    recording, its plan's counters once; off, ``staged_bytes`` is never
    called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng, cpu_batch = wide
    dev = torch.device("cuda")
    tables = ts.StepTables.on(eng.tables.host, dev)
    batch = type(cpu_batch)(*(t.to(dev) for t in cpu_batch))
    calls = []
    real = ts.staged_bytes

    def counted(plan, b):
        calls.append(1)
        return real(plan, b)
    ts.staged_bytes = counted
    try:
        ts.turbo_step(tables, batch, 4, eng.tcfg.tile)
        assert not calls
        with EVENTS.recording() as rec:
            for _ in range(3):
                ts.turbo_step(tables, batch, 4, eng.tcfg.tile)
        torch.cuda.synchronize()
    finally:
        ts.staged_bytes = real
    plan = next(iter(tables.plans.values()))
    assert len(calls) == 3
    assert rec.counters["turbo.staged_bytes"] == 3 * real(plan, batch)
    assert "turbo.tile_rows" not in rec.counters   # the plan was kept
    assert plan.lits_off < 0


# ---- a warp a row: turbo.warp_row_launches -----------------------------------

def cell_plan(cell: str):
    """A few rows of a cell's engine, as the benchmark makes them, and the
    plan its launches take on an H100 (the plan follows each row's shapes,
    not the number of rows)."""
    from portbench import run
    spec = run.load_cell(cell)
    text = run.program_text(spec["traffic"])
    eng = run.Turbo(compile_text(text), spec["config"], torch, "cpu")
    states = run.start_states(spec["traffic"], text, 2**31 + 7)
    eng.deal_rows(states, run.deal(torch, 6, len(states), 7))
    batch = eng.make(6)
    return batch, ts.tile_plan(eng.eng.tables, batch, eng.cfg.tile,
                               ts.H100_SHARED)


def compile_text(text: str):
    program = json5.loads(loader.add_line_numbers(text))
    validator.validate_program(program)
    return compile_program(program)


@pytest.mark.parametrize("cell,tile,warp", [("prompt-chain", 3, True),
                                            ("adventure", 53, False),
                                            ("lockstep", 53, False)])
def test_warp_row_launches_are_the_launches_of_a_wide_cell(cell, tile, warp):
    """``turbo.warp_row_launches``, host arithmetic with no sync, once for
    each launch that steps its rows a warp each (``count_launch``, which
    ``turbo_step`` calls once a launch on a card): over a window of the
    cell's launches it equals the launches in ``prompt-chain`` (T = 3) and
    is never counted in ``adventure`` or ``lockstep`` (T = 53)."""
    batch, plan = cell_plan(cell)
    assert (plan.tile, plan.lanes) == (tile, ts.WARP if warp else 1)
    with EVENTS.recording() as rec:
        for _ in range(5):
            ts.count_launch(plan, batch)
    assert rec.counters.get("turbo.warp_row_launches", 0) == (5 if warp
                                                              else 0)
    assert rec.counters["turbo.staged_bytes"] == 5 * ts.staged_bytes(plan,
                                                                      batch)
    ts.count_launch(plan, batch)                 # off: nothing, no error
    assert EVENTS.recorded is None


@pytest.mark.parametrize("cell", ["prompt-chain", "adventure", "lockstep"])
def test_staged_word_bytes_are_the_long_padded_rows_of_a_turbo_cell(cell):
    """``turbo.staged_word_bytes``, host arithmetic from the plan, counted
    beside ``turbo.staged_bytes`` while recording: the rows of at least
    ``WORD_ROW`` bytes, each padded to an odd number of words in shared
    memory, which the kernel stages a word a lane, a warp a row. In
    ``prompt-chain`` that is all but the 144-byte meta rows (the 512-byte
    registers, twelve 2048-byte string rows, the 4096-byte output); in
    ``adventure`` and ``lockstep`` the 512-byte registers alone."""
    batch, plan = cell_plan(cell)
    n, regw = batch.regs.shape
    staged = ts.staged_bytes(plan, batch)
    want = (staged - 2 * n * 4 * plan.cells if cell == "prompt-chain"
            else 2 * n * 4 * regw)
    assert regw == 128 and plan.cells == 36 and plan.planes == 1
    assert ts.staged_word_bytes(plan, batch) == want
    with EVENTS.recording() as rec:
        for _ in range(3):
            ts.count_launch(plan, batch)
    assert rec.counters["turbo.staged_word_bytes"] == 3 * want
    assert rec.counters["turbo.staged_bytes"] == 3 * staged


def test_staged_word_bytes_count_only_the_long_padded_rows(wide):
    """On a synthetic plan whose shared strides are all 16-byte multiples
    nothing takes the word path; where only the string rows are padded,
    their bytes alone do; rows of bytes that are no whole words (width 50)
    stage byte by byte, and padded rows under ``WORD_ROW`` bytes (width
    128) by 16-byte units, so neither is counted."""
    eng, batch = wide
    plan = ts.tile_plan(eng.tables, batch, eng.tcfg.tile, ts.H100_SHARED)
    t = plan.tile
    aligned = dataclasses.replace(
        plan, regs_is=528, meta_is=160, meta_ps=t * 160, sbuf_is=2064,
        sbuf_ps=t * 2064, out_is=4112)
    assert ts.staged_word_bytes(aligned, batch) == 0
    assert ts.staged_bytes(aligned, batch) == ts.staged_bytes(plan, batch)
    sbuf_only = dataclasses.replace(aligned, sbuf_is=plan.sbuf_is,
                                    sbuf_ps=plan.sbuf_ps)
    n, rows, width = batch.regs.shape[0], plan.rows, batch.sbuf.shape[2]
    assert ts.staged_word_bytes(sbuf_only, batch) == 2 * n * rows * width
    for narrow in (50, 128):
        cut = type(batch)(batch.regs, batch.sbuf[:, :, :narrow].contiguous(),
                          batch.out, batch.meta)
        assert ts.staged_word_bytes(plan, cut) == (
            ts.staged_word_bytes(plan, batch) - 2 * n * rows * width)


def test_turbo_step_counts_each_launch_through_count_launch():
    """The wrapper's one site: every card launch goes through
    ``count_launch`` once, before the kernel."""
    import inspect
    src = inspect.getsource(ts.turbo_step)
    assert src.count("count_launch(plan, batch)") == 1
    assert src.index("count_launch(") < src.index('launch("turbo_step"')
    assert "EVENTS.count" not in src

