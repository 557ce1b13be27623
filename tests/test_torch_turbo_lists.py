"""List instructions on the port (the plain version of the step, on the CPU)
against the exact host engine, at DONE or with the same error, and against
the JAX engine on LIST_SPINE: one named test per place where a hand port of
the TPU kernel's list branches would go wrong. Exact: every value is a byte
or an int32."""

import pytest

import torch_programs as tp
from torch_helpers import (PORT_TCFG, SIZES, agree_with_host, port_engine,
                           prog, run_jax, run_port, summary)

from interpolation_engine_tpu.vm import turbo as jax_turbo
from interpolation_engine_tpu.vm.config import PARKED
from interpolation_engine_tpu_torch.compiler.turbo import (IForHeadDyn, IPark,
                                                           plan_turbo)
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm import turbo as port_turbo
from interpolation_engine_tpu_torch.vm import turbo_tables as tt
from interpolation_engine_tpu_torch.vm.state import T_INT, T_LIST, T_STR
from interpolation_engine_tpu_torch.vm.turbo import C_PC, C_STATUS


def parks_at(src, pc, **kw):
    """One launch of the port's step stops every instance PARKED at pc,
    having counted the parking attempt as a step."""
    eng = port_engine(src, **kw)
    batch = eng.step_fn(2)(eng.make_batch(2))
    assert batch.regs[:, C_STATUS].tolist() == [PARKED] * 2
    assert batch.regs[:, C_PC].tolist() == [pc] * 2
    return eng, batch


@pytest.fixture(scope="module")
def list_spine_jax():
    return run_jax(tp.LIST_SPINE, 3)


def test_list_spine_agrees_with_host_and_jax(list_spine_jax, tmp_path,
                                             capsys):
    assert plan_turbo(port_engine(tp.LIST_SPINE).compiled).n_parks == 0
    r = agree_with_host(tp.LIST_SPINE, tmp_path, capsys, n=3)
    assert [summary(p) for p in run_port(tp.LIST_SPINE, 3)] == \
        [summary(j) for j in list_spine_jax]
    assert r.output == ("<a><b><c-0>[a,b] c-0 ['a', 'b', 'c-0'] "
                        "['a', 'b', 'a', 'c-0']")


def test_list_edge_cases_agree_with_host(tmp_path, capsys):
    r = agree_with_host(tp.LIST_EDGES, tmp_path, capsys)
    assert r.output == "[3]|[1, 'x']|[]|[3, 1, 'x']|[3, 1]|()|x"


# ---- the list repr (str(list) in a template) ---------------------------------

@pytest.mark.parametrize("elems,cell", [("['a', 'b']", (T_INT, 5, 0)),
                                        ("[1, 2]", (T_STR, 0, 1))],
                         ids=["str_list_int_element", "int_list_str_element"])
def test_repr_parks_on_an_element_of_the_other_kind(elems, cell):
    # the codec refuses such a list, so the element is written by hand
    src = prog("{l: %s}" % elems, "{cmd:'print', text:'v={l}'}")
    eng = port_engine(src)
    s = eng.plan.slot_of["l"]
    assert eng.cols.ekind(s) == ("str" if "'" in elems else "int")
    batch = eng.make_batch(2)
    plane, E = eng.cols.list_ord[s], eng.cols.E
    for k, v in enumerate(cell):
        batch.meta[plane, :, k * E + 1] = v
    ts.turbo_step_reference(eng.tables, batch, 4)
    assert batch.regs[:, C_STATUS].tolist() == [PARKED] * 2
    assert batch.regs[:, C_PC].tolist() == [0] * 2
    # the mixed list renders both kinds in the kernel
    src = prog("{l: [1, 'a']}", "{cmd:'print', text:'v={l}'}")
    eng = port_engine(src)
    batch = eng.step_fn(1)(eng.make_batch(1))
    assert eng.results(batch)[0].output == "v=[1, 'a']"


@pytest.mark.parametrize("elem", ["\"it's\"", "'a\\\\\\\\b'", "'café'",
                                  "'a\\\\{b'"],
                         ids=["quote", "backslash", "non_ascii", "brace"])
def test_repr_parks_where_python_would_escape(elem, tmp_path, capsys):
    src = prog("{l: ['ok', %s]}" % elem, "{cmd:'print', text:'v={l}'}")
    parks_at(src, 0)
    agree_with_host(src, tmp_path, capsys)


def test_repr_longer_than_width_parks(tmp_path, capsys):
    src = prog("{l: ['%s', '%s']}" % ("x" * 30, "y" * 30),
               "{cmd:'set', item:'<{l}>', output_name:'r'}",
               "{cmd:'print', text:'{r}'}")
    parks_at(src, 0)     # 68 bytes > the 64-byte slot; the sibling's 256
    r = agree_with_host(src, tmp_path, capsys)
    assert r.output == "<%s>" % ['x' * 30, 'y' * 30]


# ---- slice, append, remove, index, concat, join --------------------------------

def test_slice_is_one_based_right_inclusive_then_clamped(tmp_path, capsys):
    src = prog("{l: ['a','b','c','d','e']}",
               "{cmd:'list_slice', list:'{l}', from_index:2, to_index:3, "
               "output_name:'s1'}",
               "{cmd:'list_slice', list:'{l}', from_index:3, to_index:0, "
               "output_name:'s2'}",   # the right-bound-0 quirk: to 1
               "{cmd:'list_slice', list:'{l}', from_index:-2, to_index:-1, "
               "output_name:'s3'}",
               "{cmd:'list_slice', list:'{l}', from_index:-9, to_index:99, "
               "output_name:'s4'}",
               "{cmd:'list_slice', list:'{l}', from_index:4, to_index:2, "
               "output_name:'s5'}",
               "{cmd:'print', text:'{s1}|{s2}|{s3}|{s4}|{s5}'}")
    r = agree_with_host(src, tmp_path, capsys)
    # from -9: Python's clamp of the shifted start, -9 + 5 + 5 = 1
    assert r.output == "['b', 'c']|[]|['d', 'e']|['b', 'c', 'd', 'e']|[]"


def test_slice_from_zero_parks_to_the_host_error(tmp_path, capsys):
    src = prog("{l: ['a','b','c']}",
               "{cmd:'list_slice', list:'{l}', from_index:0, to_index:2, "
               "output_name:'s'}")
    parks_at(src, 0)
    assert agree_with_host(src, tmp_path, capsys) is None


def test_append_parks_on_a_missing_list_and_at_capacity(tmp_path, capsys):
    missing = prog("{l: ['a']}", "{cmd:'delete', wildcards:['l']}",
                   "{cmd:'list_append', list:'{l}', item:'q', "
                   "output_name:'l'}")
    parks_at(missing, 1)
    assert agree_with_host(missing, tmp_path, capsys) is None
    full = prog("{l: %s}" % [f"e{k}" for k in range(PORT_TCFG.list_cap)],
                "{cmd:'list_append', list:'{l}', item:'q', output_name:'l'}")
    eng, batch = parks_at(full, 0)
    assert batch.regs[0, eng.cols.slen(eng.plan.slot_of["l"])] == 12
    # the host's 13 elements outgrow the sibling's 12 too: an escape to the
    # general engine, which finishes it
    assert agree_with_host(full, tmp_path, capsys).inserts["l"] == [
        f"e{k}" for k in range(PORT_TCFG.list_cap)] + ["q"]


def test_append_parks_on_an_element_longer_than_its_cell(tmp_path, capsys):
    src = prog("{l: ['a'], w: '%s'}" % ("w" * 33),
               "{cmd:'list_append', list:'{l}', item:'{w}', "
               "output_name:'l'}")
    parks_at(src, 0)
    # the sibling's 128-byte cells hold it
    assert agree_with_host(src, tmp_path, capsys).inserts["l"] == \
        ["a", "w" * 33]


def test_append_to_another_slot_copies_the_source(tmp_path, capsys):
    src = prog("{a: ['x', 'y'], n: 4}",
               "{cmd:'list_append', list:'{a}', item:'z{n}', "
               "output_name:'b'}",
               "{cmd:'list_append', list:'{b}', item:'w', output_name:'b'}",
               "{cmd:'print', text:'{a} {b}'}")
    r = agree_with_host(src, tmp_path, capsys)
    assert r.output == "['x', 'y'] ['x', 'y', 'z4', 'w']"


def test_remove_takes_the_first_match_and_never_parks_on_absence(
        tmp_path, capsys):
    src = prog("{l: [1, '1', 'x', 2, 'x']}",
               "{cmd:'list_remove', list:'{l}', item:'x', output_name:'l'}",
               "{cmd:'list_remove', list:'{l}', item:'1', output_name:'m'}",
               "{cmd:'list_remove', list:'{l}', item:'absent', "
               "output_name:'l'}",
               "{cmd:'print', text:'{l} {m}'}")
    eng = port_engine(src)
    batch = eng.run(eng.make_batch(2))
    assert eng.ring_stats["parks"] == 0
    assert eng.results(batch)[0].output == "[1, '1', 2, 'x'] [1, 2, 'x']"
    agree_with_host(src, tmp_path, capsys)


@pytest.mark.parametrize("index,want,parks", [
    ("1", "a", False), ("-1", "c", False), ("'2'", "b", False),
    ("'-3'", "a", False), ("'{k}'", "b", False), ("'-{k}'", "b", False),
    ("0", None, True), ("4", None, True), ("-4", "c", True),
    ("'{big}'", None, True)],
    ids=["first", "last", "digits", "signed_digits", "copy", "template",
         "zero", "past_end", "before_start", "ten_digits"])
def test_index_is_one_based_from_either_end(index, want, parks, tmp_path,
                                            capsys):
    src = prog("{l: ['a','b','c'], k: 2, big: '1234567890'}",
               "{cmd:'list_index', list:'{l}', index:%s, output_name:'v'}"
               % index, "{cmd:'print', text:'<{v}>'}")
    if parks:   # the host then raises, or wraps around
        parks_at(src, 0)
    r = agree_with_host(src, tmp_path, capsys)
    assert (r and r.output) == (want and f"<{want}>")


def test_concat_parks_past_the_list_capacity(tmp_path, capsys):
    seven = [f"e{k}" for k in range(7)]
    ok = prog("{a: ['x'], b: ['y', 'z']}",
              "{cmd:'list_concat', lists:['{b}','{a}','{b}'], "
              "output_name:'a'}", "{cmd:'print', text:'v={a}'}")
    assert agree_with_host(ok, tmp_path, capsys).output == \
        "v=['y', 'z', 'x', 'y', 'z']"
    over = prog("{a: %s, b: %s}" % (seven, seven),
                "{cmd:'list_concat', lists:['{a}','{b}'], output_name:'c'}")
    parks_at(over, 0)    # 14 elements: past the sibling's 12 as well
    assert agree_with_host(over, tmp_path, capsys).inserts["c"] == seven * 2


def test_join_parks_on_a_non_string_element_and_on_overflow(tmp_path,
                                                            capsys):
    ints = prog("{l: [1, 'a']}",
                "{cmd:'list_join', list:'{l}', before:'<', between:',', "
                "after:'>', output_name:'j'}")
    parks_at(ints, 0)
    assert agree_with_host(ints, tmp_path, capsys) is None
    long = prog("{l: ['%s', '%s']}" % ("x" * 31, "y" * 30),
                "{cmd:'list_join', list:'{l}', before:'<', between:'--', "
                "after:'>', output_name:'j'}")
    parks_at(long, 0)    # 65 bytes with the before, between and after
    assert agree_with_host(long, tmp_path, capsys).inserts["j"] == \
        "<%s--%s>" % ("x" * 31, "y" * 30)


def test_join_renders_before_between_and_after(tmp_path, capsys):
    src = prog("{l: ['a', 'b', 'c'], e: [], s: '+'}",
               "{cmd:'list_join', list:'{l}', before:'[{s}', "
               "between:'{s}-', after:']', output_name:'j'}",
               "{cmd:'list_join', list:'{e}', before:'(', between:'{s}', "
               "after:')', output_name:'k'}",
               "{cmd:'print', text:'{j} {k}'}")
    assert agree_with_host(src, tmp_path, capsys).output == "[+a+-b+-c] ()"


def test_list_join_int_separator_parks(tmp_path, capsys):
    """A single-hole separator holding an int: the host gets the raw value
    and raises; the planner parks the join."""
    src = prog("{n: 3, l: ['a','b']}",
               "{cmd:'list_join', list:'{l}', before:'', between:'{n}', "
               "after:'', output_name:'j'}", "{cmd:'print', text:'{j}'}")
    assert isinstance(plan_turbo(port_engine(src).compiled).instrs[0], IPark)
    assert agree_with_host(src, tmp_path, capsys) is None


# ---- list literals and whole-list copies ------------------------------------------

def test_list_literal_may_read_the_list_it_replaces(tmp_path, capsys):
    src = prog("{l: ['a'], k: 7}",
               "{cmd:'set', item:['x{l}', 'y', '{k}'], output_name:'l'}",
               "{cmd:'print', text:'v={l}'}")
    eng = port_engine(src)
    assert eng.tables.host.scratch_bytes > 0
    r = agree_with_host(src, tmp_path, capsys)
    assert r.output == "v=[\"x['a']\", 'y', 7]"


def test_whole_list_set_copies_cells_or_only_registers(tmp_path, capsys):
    src = prog("{a: ['x', 'y']}",
               "{cmd:'set', item:'{a}', output_name:'b'}",
               "{cmd:'set', item:'{a}', output_name:'a'}",
               "{cmd:'list_append', list:'{a}', item:'z', output_name:'a'}",
               "{cmd:'print', text:'{a} {b}'}")
    eng = port_engine(src)
    assert eng.tables.host.ins[:2, :3].tolist() == [
        [tt.OP_SETLIST, 1, 0], [tt.OP_SETLIST, 0, 0]]
    ts.turbo_step_reference(eng.tables, batch := eng.make_batch(1), 1)
    a, b = (eng.plan.slot_of[k] for k in "ab")
    cols = eng.cols
    assert batch.regs[0, cols.stype(b)] == T_LIST
    assert batch.regs[0, cols.slen(b)] == 2
    assert batch.meta[cols.list_ord[b]].equal(batch.meta[cols.list_ord[a]])
    for r in range(cols.elem_rows):
        assert batch.sbuf[cols.list_row0[b] + r].equal(
            batch.sbuf[cols.list_row0[a] + r])
    assert agree_with_host(src, tmp_path, capsys).output == \
        "['x', 'y', 'z'] ['x', 'y']"


# ---- dynamic for ------------------------------------------------------------------

def test_for_dyn_body_mutation_parks(tmp_path, capsys):
    """The host snapshots looped lists at entry: a body that writes the
    looped slot parks the head, and the ring runs the whole loop."""
    src = prog("{lst: ['a','b']}",
               "{cmd:'for', name_list_map:{v: '{lst}'}, tasks:["
               "{cmd:'list_append', list:'{lst}', item:'{v}!', "
               "output_name:'lst'}]}", "{cmd:'print', text:'v={lst}'}")
    plan = plan_turbo(port_engine(src).compiled)
    assert not any(isinstance(i, IForHeadDyn) for i in plan.instrs)
    assert any(isinstance(i, IPark) for i in plan.instrs)
    agree_with_host(src, tmp_path, capsys)


def test_for_dyn_parks_on_lists_of_differing_lengths(tmp_path, capsys):
    src = prog("{a: ['x','y'], b: ['1']}",
               "{cmd:'for', name_list_map:{u:'{a}', v:'{b}'}, tasks:["
               "{cmd:'print', text:'{u}{v}'}]}")
    parks_at(src, 0)
    assert agree_with_host(src, tmp_path, capsys) is None


def test_for_dyn_exit_keeps_the_last_values_and_resets(tmp_path, capsys):
    src = prog("{a: ['x', 3], b: ['1', '2'], t: 0}",
               "{cmd:'label', name:'@again'}",
               "{cmd:'for', name_list_map:{u:'{a}', v:'{b}'}, tasks:["
               "{cmd:'print', text:'{u}{v};'}]}",
               "{cmd:'math', input:'{t} + 1', output_name:'t'}",
               "{cmd:'goto_map', text:'{t}', target_maps:["
               "{'2': '@end'}, {'*': '@again'}]}",
               "{cmd:'label', name:'@end'}",
               "{cmd:'print', text:'last={u}{v}'}")
    eng = port_engine(src)
    batch = eng.run(eng.make_batch(2))
    assert not batch.regs[:, eng.cols.loop(0)].any()   # reset on exit
    assert agree_with_host(src, tmp_path, capsys).output == \
        "x1;32;x1;32;last=32"


def test_list_index_template_with_literal_text(tmp_path, capsys):
    """A list_index template with literal text: the JAX engine's literal
    table lacks its literals and its kernel build fails; the port registers
    them after the JAX rows and matches the host."""
    src = prog("{l: ['a','b','c'], k: 1}",
               "{cmd:'list_index', list:'{l}', index:'-{k}', "
               "output_name:'v'}", "{cmd:'print', text:'<{v}>'}")
    assert agree_with_host(src, tmp_path, capsys).output == "<c>"
    with pytest.raises(KeyError):
        run_jax(src, 1)


def test_element_cells_follow_elem_pos_at_any_width(tmp_path, capsys):
    """At a width that is not a multiple of the element width, each byte
    row ends in unused bytes. The port places every element at
    ``_Cols.elem_pos``, as the codecs do, and matches the host; the JAX
    kernel's pool shifts treat the rows as one run of bytes and lose the
    elements past the first row."""
    src = prog("{l: ['a1','b2','c3']}",
               "{cmd:'list_append', list:'{l}', item:'d4', output_name:'l'}",
               "{cmd:'list_append', list:'{l}', item:'e5', output_name:'l'}",
               "{cmd:'list_slice', list:'{l}', from_index:2, to_index:5, "
               "output_name:'s'}", "{cmd:'print', text:'v={l} {s}'}")
    sizes = dict(SIZES, width=80)     # two 32-byte cells, 16 bytes unused
    r = agree_with_host(src, tmp_path, capsys,
                        tcfg=port_turbo.TurboConfig(**sizes))
    assert r.output == ("v=['a1', 'b2', 'c3', 'd4', 'e5'] "
                        "['b2', 'c3', 'd4', 'e5']")
    (j,) = run_jax(src, 1, jax_turbo.TurboConfig(**sizes))
    assert j.inserts["l"][3:] == ["\x00\x00", "\x00\x00"]
