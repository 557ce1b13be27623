"""The general engine's string, list, replace, delete and random opcodes
(``unescape``, ``goto_map`` with template keys, ``math``, ``list_join``,
``list_concat``, ``list_remove``, ``list_index``, ``replace_map``,
``delete``, ``delete_except``, ``random_choice``) against the JAX package's
DeviceRunner (eager) on the CPU: field for field after every launch (exact:
integer and byte state), through both rings, then at DONE against the host
engine. Then one test per hazard of a hand port of these handlers."""

import numpy as np
import pytest

import torch_programs as tp
from torch_helpers import (ANSWERS, assert_same_state, compile_port,
                           general_pair, jax_snapshot, prog, run_general_both,
                           run_host)

from interpolation_engine_tpu.vm.config import DONE, PARKED
from interpolation_engine_tpu_torch._shared import isa
from interpolation_engine_tpu_torch.ops import interp_kernel as ik
from interpolation_engine_tpu_torch.vm import state as port_state
from interpolation_engine_tpu_torch.vm import step as port_step

OPS = {name: op for op, name in isa.OP_NAMES.items()}

# one program per opcode: each runs the opcode on the device in more than
# one shape, and ends at DONE on every engine
PROGRAMS = {
    "unescape": prog(
        "{b: 'q\\\\{k\\\\}', k: 'v', n: 5}",
        "{cmd:'unescape', item:'{b}', output_name:'u1'}",
        "{cmd:'unescape', item:'lit \\\\{k\\\\}', output_name:'u2'}",
        "{cmd:'unescape', item:'{n}', output_name:'u3'}",
        "{cmd:'print', text:'{u1} {u2}'}"),
    "goto_map": prog(
        "{k: 'go', x: 'go-1', t: '@b', u: 'CONTINUE'}",
        "{cmd:'goto_map', text:'{x}', target_maps:[{'{k}': '@a'}, "
        "{'{k}-*': '{t}'}, {'*': '@a'}]}",
        "{cmd:'label', name:'@a'}", "{cmd:'print', text:'A;'}",
        "{cmd:'label', name:'@b'}", "{cmd:'print', text:'B;'}",
        "{cmd:'goto_map', text:'{nokey}', target_maps:[{'{k}': '@d'}, "
        "{'NULL': '{u}'}]}",
        "{cmd:'print', text:'C;'}",
        "{cmd:'label', name:'@d'}", "{cmd:'print', text:'D'}",
        "{cmd:'set', item:'late', output_name:'nokey'}"),
    "math": prog(
        "{k: '3', e: '2*(3+4)', n: -8, l: ['a', 'b']}",
        "{cmd:'math', input:'7 // 2 + {k}', output_name:'m1'}",
        "{cmd:'math', input:'{e} // 1', output_name:'m2'}",
        "{cmd:'math', input:'{n} % 3 - 10 // -4', output_name:'m3'}",
        "{cmd:'math', input:'max({k}, 2, 5) // 2 + length(l)', "
        "output_name:'m4'}",
        "{cmd:'print', text:'{m1} {m2} {m3} {m4}'}"),
    "list_join": prog(
        "{l: ['a', 'bb', 'c'], e: [], k: 'K'}",
        "{cmd:'list_join', list:'{l}', before:'<', between:', ', "
        "after:'>', output_name:'j1'}",
        "{cmd:'list_join', list:'{e}', before:'(', between:'-', "
        "after:')', output_name:'j2'}",
        "{cmd:'list_join', list:['x', '{k}'], before:'', between:'{k}', "
        "after:'', output_name:'j3'}",
        "{cmd:'print', text:'{j1}{j2}{j3}'}"),
    "list_concat": prog(
        "{l: ['a', 'b'], m: [1, 'c'], e: []}",
        "{cmd:'list_concat', lists:['{l}', '{m}', ['z'], '{e}'], "
        "output_name:'c'}",
        "{cmd:'list_concat', lists:['{c}'], output_name:'d'}",
        "{cmd:'list_join', list:'{l}', before:'', between:'', after:'', "
        "output_name:'s'}",
        "{cmd:'print', text:'{s}'}"),
    "list_remove": prog(
        "{l: [1, '1', 'x', 2, 'x'], k: 'x', one: 1}",
        "{cmd:'list_remove', list:'{l}', item:'{k}', output_name:'a'}",
        "{cmd:'list_remove', list:'{a}', item:'{one}', output_name:'b'}",
        "{cmd:'list_remove', list:'{b}', item:'absent', output_name:'c'}",
        "{cmd:'list_remove', list:['p', 'q'], item:'q', output_name:'d'}"),
    "list_index": prog(
        "{l: ['a', 'b', 'c'], k: 2, s: '-1'}",
        "{cmd:'list_index', list:'{l}', index:1, output_name:'i1'}",
        "{cmd:'list_index', list:'{l}', index:'{k}', output_name:'i2'}",
        "{cmd:'list_index', list:'{l}', index:'{s}', output_name:'i3'}",
        "{cmd:'list_index', list:'{l}', index:-3, output_name:'i4'}",
        "{cmd:'print', text:'{i1}{i2}{i3}{i4}'}"),
    "replace_map": prog(
        "{x: 'abc', k: 'a', n: 4}",
        "{cmd:'replace_map', item:'{x}', output_name:'r1', "
        "wildcard_maps:[{'{k}*': '{1}!'}, {'*': 'none'}]}",
        "{cmd:'replace_map', item:'aab', output_name:'r2', "
        "repeat_until_done:true, wildcard_maps:[{'a*': '{1}'}]}",
        "{cmd:'replace_map', item:'x-y-z', output_name:'r3', "
        "wildcard_maps:[{'*-*': '{2}<{1}'}]}",
        "{cmd:'replace_map', item:'{n}', output_name:'r4', "
        "wildcard_maps:[{'*': 'seen'}]}",
        "{cmd:'print', text:'{r1} {r2} {r3}'}"),
    "delete": prog(
        "{aa: 1, ab: 'x', b: 'ab', c: 'keep', zz: 0}",
        "{cmd:'delete', wildcards:['aa']}",
        "{cmd:'delete', wildcards:['z*', '{b}']}",
        "{cmd:'print', text:'{c}'}"),
    "delete_except": prog(
        "{aa: 1, ab: 'x', k: 'a', c: 'keep'}",
        "{cmd:'delete_except', wildcards:['a*', 'k', 'c']}",
        "{cmd:'delete_except', wildcards:['c', 'k']}",
        "{cmd:'print', text:'{c}'}"),
    "random_choice": prog(
        "{l: ['a', 'b', 'c', 7]}",
        "{cmd:'random_choice', list:'{l}', output_name:'r'}",
        "{cmd:'random_choice', list:['x', 'y'], output_name:'s'}"),
}


def lcg(rng: int) -> int:
    """The JAX package's random_choice step, in numpy uint32."""
    with np.errstate(over="ignore"):
        return int(np.uint32(rng) * np.uint32(1664525)
                   + np.uint32(1013904223))


def host_with_choices(src, tmp_path, capsys, choices):
    """The host engine's result where its random.choice returns
    ``choices`` in turn (the device's choice, by the LCG)."""
    from interpolation_engine_tpu.core import executor
    picks = iter(choices)
    old = executor.random.choice
    executor.random.choice = lambda seq: seq[next(picks)]
    try:
        host = run_host(src, tmp_path, ANSWERS)
    finally:
        executor.random.choice = old
    capsys.readouterr()
    return host


@pytest.mark.parametrize("opname", sorted(PROGRAMS))
def test_opcode_equals_jax_after_every_launch_and_host_at_done(
        opname, tmp_path, capsys):
    src = PROGRAMS[opname]
    assert OPS[opname] in port_step.used_opcodes(compile_port(src))
    jres, pres, runner = run_general_both(src, n=3, inner=2)
    assert runner.ring_stats["parks"] == 0
    for i, (j, p) in enumerate(zip(jres, pres)):
        assert p.status == j.status == DONE
        assert (p.output, p.inserts, p.steps) == (j.output, j.inserts,
                                                  j.steps)
        if opname == "random_choice":
            # the host's is Python's generator: give it the device's picks
            r1 = lcg(i + 1)
            picks = [(r1 >> 8) % 4, (lcg(r1) >> 8) % 2]
            host = host_with_choices(src, tmp_path, capsys, picks)
        else:
            host = run_host(src, tmp_path, ANSWERS)
            capsys.readouterr()
        assert (p.output, p.inserts) == (host["output"],
                                         dict(host["inserts"]))


def test_dispatch_table_covers_every_opcode():
    _, pr = general_pair(PROGRAMS["math"])
    assert sorted(pr.step.handlers) == list(range(isa.N_OPS))
    assert not hasattr(port_step, "DEFERRED")
    assert not hasattr(port_step, "check_ported")


def test_general_ops_program_runs_every_opcode_without_a_park(tmp_path,
                                                             capsys):
    """chip_smoke's phase-14 program: the 11 opcodes, no host park, every
    instance equal to JAX after every launch and to the host (given the
    device's random choice) at DONE."""
    src = tp.GENERAL_OPS
    ops = port_step.used_opcodes(compile_port(src))
    assert {OPS[name] for name in PROGRAMS} <= ops
    jres, pres, runner = run_general_both(src, n=4, inner=3)
    assert runner.ring_stats["parks"] == 0
    for i, (j, p) in enumerate(zip(jres, pres)):
        assert (p.status, p.output, p.inserts, p.steps) == (
            j.status, j.output, j.inserts, j.steps)
        pick = tp.general_ops_choice(i + 1)
        host = host_with_choices(src, tmp_path, capsys, [pick])
        assert p.status == DONE
        assert (p.output, p.inserts) == (host["output"],
                                         dict(host["inserts"]))


# ---------------------------------------------------------------------------
# where a hand port of these handlers is likely to go wrong
# ---------------------------------------------------------------------------

# defines the key the hazard programs find missing, after its use
LATE = "{cmd:'set', item:'late', output_name:'nokey'}"


def held(src: str, n: int = 2, inner: int = 1):
    """(jax results, port results, port runner), held equal after every
    launch; None where both raised the same error."""
    return run_general_both(src, n=n, inner=inner)


def first_launch(src: str, steps: int, n: int = 2):
    """One launch of ``steps`` steps of both engines from the same fresh
    state, held equal; returns the port's batch."""
    jr, pr = general_pair(src)
    jb = jr.make_instances(n)
    pb = port_state.from_jax(jb._asdict())
    jb, pb = jr._jitted(jb, steps), pr.launch(pb, steps)
    assert_same_state(jax_snapshot(jb), pb.to_numpy(), "launch")
    return pb


def test_goto_map_interpolates_unchosen_entries(tmp_path, capsys):
    """The first entry matches, but a later entry's key names a missing
    key: the reference interpolates every entry first, so the task raises
    (parks, and the host raises its error), on both engines."""
    src = prog("{x: 'go'}",
               "{cmd:'goto_map', text:'{x}', target_maps:[{'go': '@a'}, "
               "{'{absent}': '@a'}]}",
               "{cmd:'label', name:'@a'}", "{cmd:'print', text:'A'}",
               "{cmd:'set', item:'z', output_name:'absent'}")
    pb = first_launch(src, 1)
    assert pb.status.tolist() == [PARKED] * 2
    assert pb.last_err.tolist() == [ik.ERR_MISSING] * 2
    assert held(src) is None
    # an unchosen target that misses does the same
    src2 = src.replace("{'{absent}': '@a'}", "{'zz': '{absent}'}")
    assert first_launch(src2, 1).last_err.tolist() == [ik.ERR_MISSING] * 2


def test_replace_map_captures_stage_into_a_temporary_store(tmp_path, capsys):
    """Two captures read back as {1} and {2} in the value; the keys '1'
    and '2' do not survive into the instance's store."""
    src = prog("{s: 'key=val'}",
               "{cmd:'replace_map', item:'{s}', output_name:'r', "
               "wildcard_maps:[{'*=*': '{2}:{1}'}]}",
               "{cmd:'print', text:'{r}'}")
    jres, pres, runner = held(src)
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    assert runner.ring_stats["parks"] == 0
    assert pres[0].output == host["output"] == "val:key"
    assert "1" not in pres[0].inserts and "2" not in pres[0].inserts
    assert [p.inserts for p in pres] == [j.inserts for j in jres]


def test_replace_map_repeat_runs_to_max_fix_then_defers(tmp_path, capsys):
    """repeat_until_done: 'aaab' loses one 'a' a round and is stable after
    three changes plus one check, within max_fix (4); 'aaaaab' does not
    converge in max_fix rounds and defers to the host (ERR_HOST), which
    finishes it."""
    fits = prog("{}", "{cmd:'replace_map', item:'aaab', output_name:'r', "
                "repeat_until_done:true, wildcard_maps:[{'a*': '{1}'}]}")
    pb = first_launch(fits, 1)
    assert pb.last_err.tolist() == [ik.ERR_OK] * 2
    assert port_state.decode_inserts(port_state.row_of(
        pb.to_numpy(), 0)) == {"r": "b"}
    over = fits.replace("aaab", "aaaaab")
    pb = first_launch(over, 1)
    assert pb.last_err.tolist() == [ik.ERR_HOST] * 2
    jres, pres, _ = held(over)
    host = run_host(over, tmp_path, ANSWERS)
    capsys.readouterr()
    assert pres[0].inserts == host["inserts"] == {"r": "b"}


def test_replace_map_null_entry_and_its_absence(tmp_path, capsys):
    """A missing key takes the NULL entry's value raw (not interpolated);
    without a NULL entry it is ERR_ASSERT and the host raises."""
    src = prog("{}", "{cmd:'replace_map', item:'{nokey}', output_name:'r', "
               "wildcard_maps:[{'*': 'x'}, {'NULL': 'raw \\\\{k\\\\}'}]}",
               LATE)
    pb = first_launch(src, 1)
    assert pb.last_err.tolist() == [ik.ERR_OK] * 2
    jres, pres, _ = held(src)
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    assert pres[0].inserts == dict(host["inserts"])
    no_null = prog("{}", "{cmd:'replace_map', item:'{nokey}', "
                   "output_name:'r', wildcard_maps:[{'*': 'x'}]}", LATE)
    assert first_launch(no_null, 1).last_err.tolist() == [ik.ERR_ASSERT] * 2
    assert held(no_null) is None


def test_replace_map_int_item_passes_through(tmp_path, capsys):
    src = prog("{n: 42}", "{cmd:'replace_map', item:'{n}', output_name:'r', "
               "wildcard_maps:[{'4*': 'four'}]}")
    jres, pres, runner = held(src)
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    assert runner.ring_stats["parks"] == 0
    assert pres[0].inserts["r"] == host["inserts"]["r"] == 42


def test_delete_sees_keys_deleted_at_earlier_slots(tmp_path, capsys):
    """Slot by slot: the wildcard '{a}' reads key a; a is deleted at its
    own (earlier) slot by the wildcard 'a', so at the next occupied slot
    '{a}' is missing: an error on the device (the host, which interpolated
    the wildcards once, then does it)."""
    src = prog("{a: 'b', b: 1, c: 'two'}",
               "{cmd:'delete', wildcards:['a', '{a}']}",
               "{cmd:'print', text:'{c}'}")
    pb = first_launch(src, 1)
    assert pb.last_err.tolist() == [ik.ERR_MISSING] * 2
    assert pb.status.tolist() == [PARKED] * 2
    jres, pres, _ = held(src)
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    for j, p in zip(jres, pres):
        assert (p.output, p.inserts) == (j.output, j.inserts) == (
            host["output"], dict(host["inserts"]))
    # where the key it names sits at the last occupied slot, every
    # interpolation of the wildcard sees it present
    later = prog("{c: 'two', b: 1, a: 'b'}",
                 "{cmd:'delete', wildcards:['{a}', 'a']}")
    assert first_launch(later, 1).last_err.tolist() == [ik.ERR_OK] * 2


def test_list_concat_keeps_the_lists_before_an_error(tmp_path, capsys):
    """The second list is missing: the handler's state keeps the first
    list's copy (pool 2-3) and the missing one's too (its lookup reports
    slot 0's span, as the JAX lookup does: pool 4-5), the third list is
    not copied, the error parks the row and nothing commits; the host
    then raises its error."""
    src = prog("{l: ['a', 'b']}",
               "{cmd:'list_concat', lists:['{l}', '{nolist}', '{l}'], "
               "output_name:'c'}",
               "{cmd:'set', item:['x'], output_name:'nolist'}")
    _, pr = general_pair(src)
    st = pr.make_instances(2)
    code = np.asarray(pr.compiled.code).reshape(-1, 4)
    op, a, b, c = (int(v) for v in code[0])
    inner = pr.step.h_list_concat
    seen = {}

    def record(st_in, err, new, jump_pc=None, _adv=pr.step.advance):
        seen["new"], seen["err"] = new, err
        return _adv(st_in, err, new, jump_pc)
    pr.step.advance = record
    out = inner(st, a, b, c)
    assert seen["err"].tolist() == [ik.ERR_MISSING] * 2
    assert seen["new"].pool_top.tolist() == [6, 6]
    assert seen["new"].pool_type[:, 2:8].tolist() == [[2, 2, 2, 2, 0, 0]] * 2
    assert out.pool_type[:, 2:6].tolist() == [[0] * 4] * 2  # not committed
    assert out.pool_top.tolist() == [2, 2]
    assert held(src) is None


def test_random_choice_wraps_at_2_pow_32(tmp_path, capsys):
    """rng near 2^32: the multiply-add wraps in uint32, as JAX computes
    it; the chosen index and the new rng follow the LCG."""
    src = PROGRAMS["random_choice"]
    jr, pr = general_pair(src)
    jb = jr.make_instances(3)
    rngs = np.array([2 ** 32 - 1, 2 ** 32 - 7, 2 ** 31], np.uint32)
    jb = jb._replace(rng=jb.rng.at[:].set(rngs))
    pb = port_state.from_jax(jb._asdict())
    jb, pb = jr._jitted(jb, 1), pr.launch(pb, 1)
    assert_same_state(jax_snapshot(jb), pb.to_numpy(), "wrap")
    host = pb.to_numpy()
    for r, rng in enumerate(rngs.tolist()):
        want = lcg(rng)
        assert int(host["rng"][r]) == want
        row = port_state.decode_inserts(port_state.row_of(host, r))
        assert row["r"] == ["a", "b", "c", 7][(want >> 8) % 4]


def test_random_choice_of_an_empty_list_is_an_assert(tmp_path, capsys):
    src = prog("{e: []}", "{cmd:'random_choice', list:'{e}', "
               "output_name:'r'}")
    pb = first_launch(src, 1)
    assert pb.last_err.tolist() == [ik.ERR_ASSERT] * 2
    assert pb.rng.tolist() == [1, 2]        # the rng does not move
    assert held(src) is None


@pytest.mark.parametrize("index,err", [("0", ik.ERR_ASSERT),
                                       ("-4", ik.ERR_ASSERT),
                                       ("'0'", ik.ERR_ASSERT),
                                       ("'-1'", ik.ERR_OK),
                                       ("'1x'", ik.ERR_HOST)],
                         ids=["zero", "before_start", "zero_string",
                              "negative_string", "not_a_number"])
def test_list_index_zero_and_negative(index, err, tmp_path, capsys):
    src = prog("{l: ['a', 'b', 'c']}",
               "{cmd:'list_index', list:'{l}', index:%s, output_name:'v'}"
               % index)
    assert first_launch(src, 1).last_err.tolist() == [err] * 2
    out = held(src)
    if err == ik.ERR_OK:
        assert out[1][0].inserts["v"] == "c"


def test_list_join_with_an_int_element_defers(tmp_path, capsys):
    src = prog("{l: ['a', 3]}",
               "{cmd:'list_join', list:'{l}', before:'', between:',', "
               "after:'', output_name:'j'}")
    assert first_launch(src, 1).last_err.tolist() == [ik.ERR_HOST] * 2
    assert held(src) is None     # the host's TypeError, on both engines


@pytest.mark.parametrize("key", ["{k}", "{k}*", "*{tail}"],
                         ids=["exact", "suffix_star", "prefix_star"])
def test_template_keys_keep_the_end_anchor_quirk(key, tmp_path, capsys):
    """A template key matches text with one trailing newline as Python's
    '$' does (before that newline), in goto_map and in replace_map."""
    src = prog("{k: 'hello', tail: 'llo'}",
               "{cmd:'set', item:'hello\\n', output_name:'v'}",
               "{cmd:'replace_map', item:'{v}', output_name:'r', "
               "wildcard_maps:[{'%s': 'hit'}, {'*': 'miss'}]}" % key,
               "{cmd:'goto_map', text:'{v}', target_maps:[{'%s': '@yes'}, "
               "{'*': '@no'}]}" % key,
               "{cmd:'label', name:'@yes'}", "{cmd:'print', text:'yes {r}'}",
               "{cmd:'goto', name:'@end'}",
               "{cmd:'label', name:'@no'}", "{cmd:'print', text:'no {r}'}",
               "{cmd:'label', name:'@end'}")
    jres, pres, runner = held(src)
    host = run_host(src, tmp_path, ANSWERS)
    capsys.readouterr()
    assert runner.ring_stats["parks"] == 0
    assert pres[0].output == host["output"] == "yes hit"
    assert [(p.output, p.inserts) for p in pres] == [
        (j.output, j.inserts) for j in jres]
