"""The port's ``DeviceProgramRun``, the device engine's interactive run with
the reference's Esc menu, against the JAX package's on the CPU: Save then
Quit, Load resumes, a device slot loads on the host engine, the spliced
file equals the one JAX's run writes; and the CLI route, with
``IE_TPU_TURBO`` read as the JAX package reads it."""

import asyncio

import pytest
import torch

import torch_programs as tp
from test_device_menu import MenuScriptedBackend
from torch_helpers import PortMenuBackend

from interpolation_engine_tpu import json5
from interpolation_engine_tpu.io.manager import IOManager
from interpolation_engine_tpu.vm import driver as jd
from interpolation_engine_tpu_torch import _shared as port
from interpolation_engine_tpu_torch.vm import driver as pd

SLOT3 = """    save_states : {
        "3": {
            "inserts": {"a": "first", "b": "loaded-answer"},
            "label": "pre",
            "order_index": 4,
            "output": "first "
        }
    },"""


def _port_run(path, responses, menu_at_input=1, device="cpu"):
    holder: dict = {}
    backend = PortMenuBackend(responses, menu_at_input, holder)
    run = pd.DeviceProgramRun(str(path), [],
                              port.io_manager.IOManager(backend),
                              device=device)
    holder["run"] = run
    return run, backend


def run_port_menu(path, responses, menu_at_input=1):
    port.loader.invalidate_cache()
    run, backend = _port_run(path, responses, menu_at_input)
    return run, backend, asyncio.run(run.run())


def run_jax_menu(path, responses, menu_at_input=1):
    holder: dict = {}
    backend = MenuScriptedBackend(responses, menu_at_input, holder)
    run = jd.DeviceProgramRun(str(path), [], IOManager(backend))
    holder["run"] = run
    return asyncio.run(run.run())


def test_save_then_quit_splices_what_jax_splices(tmp_path, capsys):
    """Esc at the user_input, Save State to slot 1 with a label, Quit: the
    slot is the reference's cursor format, and the file is byte for byte
    the one the JAX package's DeviceProgramRun writes."""
    script = ["1", "1", "checkpoint-1", "4"]
    paths = [tmp_path / "port.json5", tmp_path / "jax.json5"]
    for path in paths:
        path.write_text(tp.MENU_SRC)
    run, _, output = run_port_menu(paths[0], script)
    run_jax_menu(paths[1], script)
    capsys.readouterr()
    assert paths[0].read_text() == paths[1].read_text()
    saved = json5.loads(paths[0].read_text())["save_states"]["1"]
    assert saved == {"inserts": {"a": "first"}, "output": "first ",
                     "order_index": 3, "label": "checkpoint-1"}
    assert output == "first " and run.killme


def test_load_resumes(tmp_path, capsys):
    path = tmp_path / "prog.json5"
    path.write_text(tp.MENU_SRC.replace("    save_states : {\n    },", SLOT3))
    port.loader.invalidate_cache()
    run, backend = _port_run(path, ["2", "3"])

    async def drive():
        task = asyncio.create_task(run.run())
        while len(backend.exchanges) < 2:
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        run.toggle_menu()   # close the menu: the loaded row runs on
        return await task

    assert asyncio.run(drive()) == "first loaded-answer"
    assert capsys.readouterr().out.strip() == "first loaded-answer"


@pytest.mark.parametrize("slot,status", [
    ("5", "\nCannot load empty slot.\n"),
    ("3", "\nstate has block cursors below a host-op task "
          "['order_index/serial-1/print-2']; resume requires the host "
          "engine\n")])
def test_load_refusals_show_as_the_status(tmp_path, capsys, slot, status):
    """An empty slot is refused, and a slot the device cannot resume shows
    the load's ValueError as the menu's status; the row stays as it was."""
    bad = SLOT3.replace('"order_index": 4,', '"order_index": 4, '
                        '"order_index/serial-1/print-2": 2,')
    path = tmp_path / "prog.json5"
    path.write_text(tp.MENU_SRC.replace("    save_states : {\n    },", bad))
    descriptions = []
    script = ["2", slot, "4"]

    class Recording(PortMenuBackend):
        async def select_index(self, options, description=None):
            descriptions.append(description)
            return await super().select_index(options, description)

    port.loader.invalidate_cache()
    holder: dict = {}
    backend = Recording(script, 1, holder)
    run = pd.DeviceProgramRun(str(path), [],
                              port.io_manager.IOManager(backend),
                              device="cpu")
    holder["run"] = run
    output = asyncio.run(run.run())
    capsys.readouterr()
    assert descriptions[-1] == f"\n{status}"
    assert output == "first "


def test_reload_and_restart_keeps_the_args(tmp_path, capsys):
    src = tp.MENU_SRC.replace("item:'first'", "item:'{ARG1}'")
    path = tmp_path / "prog.json5"
    path.write_text(src)
    port.loader.invalidate_cache()
    holder: dict = {}
    backend = PortMenuBackend(["3"], 1, holder)
    run = pd.DeviceProgramRun(str(path), ["arg-one"],
                              port.io_manager.IOManager(backend),
                              device="cpu")
    holder["run"] = run
    first = run

    async def drive():
        task = asyncio.create_task(run.run())
        while not backend.exchanges:
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        backend.responses.append("typed")
        first.toggle_menu()
        return await task

    assert asyncio.run(drive()) == "arg-one typed"
    capsys.readouterr()


def test_device_slot_loads_on_the_port_host(tmp_path, capsys):
    """A slot the device menu saved resumes through the port's host menu
    (tests/test_device_menu.py:97-155 on the port)."""
    path = tmp_path / "prog.json5"
    path.write_text(tp.MENU_SRC)
    run_port_menu(path, ["1", "2", "from-device", "4"])
    capsys.readouterr()
    holder: dict = {}

    class SplitBackend(port.io_manager.ScriptedBackend):
        def __init__(self):
            super().__init__([])
            self.selects, self.inputs = ["2", "2"], ["typed!"]
            self.n_inputs = self.n_selects = 0

        async def user_input(self, prompt, default=""):
            self.n_inputs += 1
            if self.n_inputs == 1:
                holder["run"].toggle_menu()
                await asyncio.Event().wait()
            return self.inputs.pop(0)

        async def select_index(self, options, description=None):
            if not self.selects:
                await asyncio.Event().wait()
            self.n_selects += 1
            return int(self.selects.pop(0)) - 1

    backend = SplitBackend()
    port.loader.invalidate_cache()
    host = port.runtime.ProgramRun(str(path), [],
                                   port.io_manager.IOManager(backend))
    holder["run"] = host

    async def drive():
        task = asyncio.create_task(host.run())
        while backend.n_selects < 2:
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.1)
        host.toggle_menu()
        return await task

    assert asyncio.run(drive())["output"] == "first typed!"
    capsys.readouterr()


def test_a_cancelled_round_leaves_the_row_as_it_was(tmp_path, capsys):
    """Esc during the service of a park: the row is the parked row still,
    so closing the menu services the same user_input again."""
    path = tmp_path / "prog.json5"
    path.write_text(tp.MENU_SRC)
    port.loader.invalidate_cache()
    run, backend = _port_run(path, [])
    seen = {}

    async def drive():
        task = asyncio.create_task(run.run())
        while not run.menu_open:
            await asyncio.sleep(0.02)
        seen["status"] = int(run.batch.status[0])
        seen["pc"] = int(run.batch.park_arg[0])
        backend.responses.append("again")
        run.toggle_menu()
        return await task

    assert asyncio.run(drive()) == "first again"
    assert seen == {"status": port.vm_config.PARKED, "pc": 2}
    assert backend.n_inputs == 2
    capsys.readouterr()


# ---- the route ---------------------------------------------------------------------

def _route(monkeypatch, tmp_path, src, batch, env):
    """The classes ``run_program_on_device`` made, on the CPU."""
    made = []
    for name in ("DeviceRunner", "TurboEngine", "DeviceProgramRun"):
        cls = getattr(pd, name)

        def make(*args, _cls=cls, **kw):
            made.append(_cls.__name__)
            return _cls(*args, **kw)
        monkeypatch.setattr(pd, name, make)
    if env is None:
        monkeypatch.delenv("IE_TPU_TURBO", raising=False)
    else:
        monkeypatch.setenv("IE_TPU_TURBO", env)
    path = tmp_path / "p.json5"
    path.write_text(src)
    port.loader.invalidate_cache()
    io = port.io_manager.IOManager(port.io_manager.ScriptedBackend(["ans"] * batch))
    assert pd.run_program_on_device(str(path), [], io, batch=batch,
                                    device="cpu") == 0
    return made


@pytest.mark.parametrize("env,batch,want", [
    (None, 1, ["DeviceProgramRun", "DeviceRunner"]),
    ("0", 1, ["DeviceProgramRun", "DeviceRunner"]),
    ("1", 1, ["TurboEngine"]),
    (None, 2, ["TurboEngine"]),
    ("0", 2, ["DeviceRunner"]),
    ("1", 2, ["TurboEngine"])])
def test_ie_tpu_turbo_routes_as_jax(monkeypatch, tmp_path, capsys, env,
                                    batch, want):
    """Batch 1 runs DeviceProgramRun unless IE_TPU_TURBO=1; =0 sends every
    batch to the general engine; otherwise the turbo engine first. Each
    prints the host CLI's line."""
    made = _route(monkeypatch, tmp_path, tp.SAVE_SRC, batch, env)
    assert made == want
    assert capsys.readouterr().out == "[v1][ans]\n"


def test_the_route_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "p.json5"
    path.write_text(tp.SAVE_SRC)
    with pytest.raises(RuntimeError, match="CUDA"):
        pd.run_program_on_device(str(path), [], io=None)
