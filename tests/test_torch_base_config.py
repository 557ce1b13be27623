"""The turbo engine's widths sized from the program (``vm/turbo.py``
``base_config``) and the normal entry that uses them
(``run_program_on_device`` without ``tcfg``), on the CPU: the first of
``TurboConfig()`` and its widenings by 4 whose width holds the plan's
longest byte literal, ``NotTurbo`` past ``MAX_WIDTH``."""

import pytest

from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch import cli
from interpolation_engine_tpu_torch.ops.turbo_step import MAX_WIDTH
from interpolation_engine_tpu_torch.vm import driver
from interpolation_engine_tpu_torch.vm.turbo import (NotTurbo, TurboConfig,
                                                     base_config)

CHAIN = [TurboConfig(),
         TurboConfig(width=512, out_width=1024, elem_width=128),
         TurboConfig(width=2048, out_width=4096, elem_width=512)]


def literal(n: int) -> str:
    """n bytes of text with a space every few letters and no brace."""
    return ("abcdefg " * (n // 8 + 1))[:n]


def program(n: int) -> str:
    """A literal of n bytes set and printed, beside short ones."""
    return """
{
    default_state: {order_index: 1, inserts: {k: 1}},
    order: [
        {cmd:'set', item:'%s', output_name:'x'},
        {cmd:'math', input:'{k} + 1', output_name:'k'},
        {cmd:'print', text:'{x}|k={k}'},
    ],
    named_tasks: {}, save_states: {},
}
""" % literal(n)


def plan_of(src: str):
    program = port.json5.loads(port.loader.add_line_numbers(src))
    port.validator.validate_program(program)
    return port.planner.plan_turbo(port.compile_program(program))


@pytest.mark.parametrize("n,want", [(1, 0), (128, 0), (129, 1), (512, 1),
                                    (513, 2), (2048, 2)])
def test_the_first_config_of_the_chain_that_holds_the_literal(n, want):
    assert base_config(plan_of(program(n))) == CHAIN[want]


def test_the_chain_ends_at_the_kernels_widest_slot():
    assert CHAIN[-1].width == MAX_WIDTH
    for a, b in zip(CHAIN, CHAIN[1:]):
        assert (b.width, b.out_width, b.elem_width) == (
            4 * a.width, 4 * a.out_width, 4 * a.elem_width)
        assert (b.tile, b.k_steps, b.list_cap) == (a.tile, a.k_steps,
                                                   a.list_cap)


def test_a_literal_past_the_widest_slot_stays_not_turbo():
    with pytest.raises(NotTurbo, match="literal longer than slot width"):
        base_config(plan_of(program(MAX_WIDTH + 1)))


def test_a_literal_in_a_goto_map_pattern_counts_too():
    src = """
{
    default_state: {order_index: 1, inserts: {t: 'a'}},
    order: [
        {cmd:'goto_map', text:'{t}', target_maps:[
            {'%s*': '@end'}, {'*': '@end'}]},
        {cmd:'label', name:'@end'},
        {cmd:'print', text:'{t}'},
    ],
    named_tasks: {}, save_states: {},
}
""" % literal(300)
    assert base_config(plan_of(src)) == CHAIN[1]


def run_both(monkeypatch, tmp_path, capsys, src, batch=2, **kw):
    """``run_program_on_device`` on the CPU and the port's host CLI on
    one program: their stdout and the TurboConfigs the entry built its
    turbo engines with."""
    made = []
    cls = driver.TurboEngine

    def make(compiled, tcfg=None, *args, **kwargs):
        made.append(tcfg)
        return cls(compiled, tcfg, *args, **kwargs)
    monkeypatch.setattr(driver, "TurboEngine", make)
    monkeypatch.delenv("IE_TPU_TURBO", raising=False)
    path = tmp_path / "p.json5"
    path.write_text(src)
    port.loader.invalidate_cache()
    io = port.io_manager.IOManager(port.io_manager.BufferBackend())
    assert driver.run_program_on_device(str(path), [], io, batch=batch,
                                        device="cpu", **kw) == 0
    device_out = capsys.readouterr().out
    port.loader.invalidate_cache()
    assert cli.main([str(path)]) == 0
    return device_out, capsys.readouterr().out, made


@pytest.mark.parametrize("n,want", [(100, 0), (128, 0), (300, 1), (512, 1),
                                    (600, 2), (2048, 2)])
def test_the_entry_runs_the_program_on_the_turbo_engine_it_sizes(
        monkeypatch, tmp_path, capsys, n, want):
    """A literal of 129-2,048 bytes no longer sends the program to the
    general engine: the turbo engine runs it at the first width of the
    chain that holds it, and prints what the host engine prints."""
    device_out, host_out, made = run_both(monkeypatch, tmp_path, capsys,
                                          program(n))
    assert made == [CHAIN[want]]
    assert device_out == host_out == literal(n) + "|k=2\n"


def test_a_tcfg_the_caller_gives_is_kept(monkeypatch, tmp_path, capsys):
    tcfg = TurboConfig(tile=8, width=1024, out_width=2048, k_steps=8)
    device_out, host_out, made = run_both(monkeypatch, tmp_path, capsys,
                                          program(600), tcfg=tcfg)
    assert made == [tcfg] and device_out == host_out


def test_past_the_widest_slot_the_general_engine_runs_it(
        monkeypatch, tmp_path, capsys):
    device_out, host_out, made = run_both(monkeypatch, tmp_path, capsys,
                                          program(MAX_WIDTH + 1))
    assert made == [] and device_out == host_out
