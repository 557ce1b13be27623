"""The port's engine around the step: the exact host ring (``run_async``)
with scripted user input, the output spill, what it refuses, the step
wrapper's checks and the CLI entry."""

import pytest
import torch

import torch_programs as tp
from torch_helpers import (PORT_TCFG, port_engine, run_host, run_jax,
                           summary)

from interpolation_engine_tpu.vm.config import DONE, PARK_USER_INPUT
from interpolation_engine_tpu_torch import cli
from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import turbo_step as ts
from interpolation_engine_tpu_torch.vm import turbo as port_turbo
from interpolation_engine_tpu_torch.vm.driver import run_program_on_device

FOR_PARK = """
{
    default_state: {order_index: 1, inserts: {}},
    order: [
        {cmd:'for', name_list_map:{q: ['first', 'second']}, tasks:[
            {cmd:'user_input', prompt:'{q}? ', output_name:'ans'},
            {cmd:'print', text:'{q}={ans};'},
        ]},
        {cmd:'print', text:'done'},
    ],
    named_tasks: {}, save_states: {},
}
"""

SPILL_CLEAR = """
{
    default_state: {order_index: 1, inserts: {i: 0}},
    order: [
        {cmd:'label', name:'@loop'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'print', text:'line {i} of text;'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'12': '@wipe'}, {'*': '@loop'}]},
        {cmd:'label', name:'@wipe'},
        {cmd:'clear'},
        {cmd:'label', name:'@post'},
        {cmd:'math', input:'{i} + 1', output_name:'i'},
        {cmd:'print', text:'after {i};'},
        {cmd:'goto_map', text:'{i}', target_maps:[
            {'15': '@end'}, {'*': '@post'}]},
        {cmd:'label', name:'@end'},
    ],
    named_tasks: {}, save_states: {},
}
"""

SPILL_TCFG = port_turbo.TurboConfig(tile=8, width=64, out_width=48,
                                    k_steps=16)


@pytest.mark.parametrize("src,responses", [
    (tp.USER_INPUT, ["ada"]), (FOR_PARK, ["A", "B"])],
    ids=["user_input", "for_with_leaf_park"])
def test_user_input_parks_and_resumes(src, responses, tmp_path, capsys):
    host = run_host(src, tmp_path, responses)
    capsys.readouterr()
    eng = port_engine(src, responses=responses)
    results = eng.results(eng.run(eng.make_batch(2), max_rounds=500))
    jax_res = run_jax(src, 2, responses=responses)
    for r, j in zip(results, jax_res):
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))
        assert summary(r) == summary(j)
    assert eng.ring_stats["parks_by_kind"] == {
        PARK_USER_INPUT: 2 * len(responses)}


@pytest.mark.parametrize("src", [tp.OUTPUT_OVERFLOW, SPILL_CLEAR],
                         ids=["print_heavy", "invalidated_by_clear"])
def test_output_spill(src, tmp_path, capsys):
    host = run_host(src, tmp_path)
    capsys.readouterr()
    eng = port_engine(src, SPILL_TCFG)
    for r in eng.results(eng.run(eng.make_batch(3), max_rounds=500)):
        assert r.status == DONE
        assert r.output == host["output"]


def test_value_too_wide_raises_not_ported(tmp_path, capsys):
    """A value too wide even for the 4x sibling (500 bytes against 256)
    escapes: the instance finishes in one batch of the general engine,
    equal to the host and to the JAX engine."""
    answer = ["x" * 500]
    host = run_host(tp.USER_INPUT, tmp_path, answer)
    capsys.readouterr()
    eng = port_engine(tp.USER_INPUT, responses=answer)
    res = eng.results(eng.run(eng.make_batch(1), max_rounds=500))
    assert sorted(eng._escape_results) == [0]
    assert [r.instance_ids for r in eng.escape_runners] == [[0]]
    assert res[0].status == DONE
    assert (res[0].output, res[0].inserts) == (host["output"],
                                               dict(host["inserts"]))
    assert summary(res[0]) == summary(run_jax(tp.USER_INPUT, 1,
                                              responses=answer)[0])


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "exact"])
def test_value_too_wide_promotes_to_the_sibling(fast, tmp_path, capsys):
    """200 bytes outgrow the 64-byte slot and fit the 256-byte sibling: the
    instance finishes there, equal to the host, through either park path."""
    answer = ["y" * 200]
    host = run_host(tp.USER_INPUT, tmp_path, answer)
    capsys.readouterr()
    eng = port_engine(tp.USER_INPUT, responses=answer, fast=fast)
    results = eng.results(eng.run(eng.make_batch(2), max_rounds=500))
    assert sorted(eng._escape_results) == [0, 1]
    assert eng.ring_stats["escapes"] == 2
    assert eng.ring_stats["fast_parks"] == (2 if fast else 0)
    for r in results:
        assert r.status == DONE
        assert (r.output, r.inserts) == (host["output"],
                                         dict(host["inserts"]))


def test_step_checks_rows_dtype_and_layout():
    eng = port_engine(tp.COPY_TYPES)
    batch = eng.make_batch(2)
    with pytest.raises(ValueError, match="rows"):
        eng.step_fn(3)(batch)
    bad = batch._replace(regs=batch.regs.long())
    with pytest.raises(ValueError, match="regs"):
        ts.turbo_step(eng.tables, bad, 4)
    bad = batch._replace(out=batch.out.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        ts.turbo_step(eng.tables, bad, 4)
    bad = batch._replace(sbuf=batch.sbuf[:, :, :32].contiguous())
    with pytest.raises(ValueError, match="width"):
        ts.turbo_step(eng.tables, bad, 4)


def test_cpu_step_runs_the_plain_version_only():
    eng = port_engine(tp.COPY_TYPES)
    step, batch = eng.step_fn(2), eng.make_batch(2)
    with EVENTS.recording() as rec:
        step(batch)
    assert rec.counters == {"plain.turbo_step": 1}


def test_engine_takes_an_explicit_device():
    from interpolation_engine_tpu_torch.vm.turbo import TurboEngine
    with pytest.raises(TypeError):
        TurboEngine(port_engine(tp.COPY_TYPES).compiled, PORT_TCFG)


def test_device_entry_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "p.json5"
    path.write_text(tp.COPY_TYPES)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_program_on_device(str(path), [], io=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--engine", "device", "--batch", "2", str(path)])


def test_cli_host_route_prints_the_output(tmp_path, capsys):
    path = tmp_path / "p.json5"
    path.write_text(tp.COPY_TYPES)
    assert cli.main([str(path)]) == 0
    assert capsys.readouterr().out == "d=-84 s2=str val n2=-42\n"
