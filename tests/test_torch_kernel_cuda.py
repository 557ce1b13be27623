"""The CUDA step kernel against its plain PyTorch version on the card: bit
for bit (regs, sbuf, out and meta) after every launch. Runs where
``torch.cuda.is_available()``;
skips elsewhere (``python -m pytest tests/test_torch_kernel_cuda.py`` on the
card, or ``python3 chip_smoke.py``, which covers the same at full size)."""

import random

import pytest
import torch

import bench
import torch_programs as tp

from interpolation_engine_tpu_torch.ops.turbo_step import (
    turbo_step, turbo_step_reference)
from interpolation_engine_tpu_torch.vm.turbo import TurboConfig, TurboEngine

pytestmark = pytest.mark.cuda

PROGRAMS = dict(tp.AGREEING, **tp.LIST_AGREEING, spine=bench.BENCH_PROGRAM,
                interp=bench.INTERP_PROGRAM,
                ring=bench.RING_PROGRAM.replace("sel: 'spin'", "sel: 'park'"),
                overflow=tp.INT32_OVERFLOW, inexact=tp.INEXACT_DIV,
                await_not_ready=tp.AWAIT_NOT_READY,
                adventure=bench.adventure_program(),
                race_io=bench.race_io_program(),
                midblock_wait=tp.MIDBLOCK_PARK % {"mode": "wait"},
                midblock_race=tp.MIDBLOCK_PARK % {"mode": "race"},
                parked_freeze_par=tp.PARKED_FREEZE_PAR,
                spill_parallel=tp.SPILL_PARALLEL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def compile_src(src):
    from interpolation_engine_tpu_torch._shared import (
        compile_program, json5, loader)
    return compile_program(json5.loads(loader.add_line_numbers(src)))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_kernel_equals_plain_after_every_launch(name, cuda):
    eng = TurboEngine(compile_src(PROGRAMS[name]),
                      TurboConfig(width=128, out_width=192, k_steps=8),
                      device=cuda)
    batch = eng.make_batch(300)
    for key in ("i", "turn"):   # lanes leave their loops at other rounds
        slot = eng.plan.slot_of.get(key)
        if slot is not None:
            gen = torch.Generator().manual_seed(0)
            batch.regs[:, eng.cols.sint(slot)] = torch.randint(
                0, 40, (300,), generator=gen, dtype=torch.int32).to(cuda)
    kern = type(batch)(*(t.clone() for t in batch))
    for _ in range(6):
        turbo_step(eng.tables, kern, 8)
        turbo_step_reference(eng.tables, batch, 8)
        torch.cuda.synchronize()
        for k, r in zip(kern, batch):
            assert torch.equal(k, r)


@pytest.mark.parametrize("idx", range(64))
def test_kernel_equals_plain_on_random_programs(idx, cuda):
    from interpolation_engine_tpu_torch._shared import json5
    program = (tp.random_scalar_program(random.Random(7000 + idx))
               if idx < 40 else tp.random_program(random.Random(9000 + idx)))
    eng = TurboEngine(compile_src(json5.dumps(program, indent=2)),
                      TurboConfig(width=64, out_width=64, k_steps=2),
                      device=cuda)
    batch = eng.make_batch(64)
    # k2 starts as an int: give each lane its own, so lanes take their own
    # branches through goto_map and math
    gen = torch.Generator().manual_seed(idx)
    batch.regs[:, eng.cols.sint(eng.plan.slot_of["k2"])] = torch.randint(
        -99, 100, (64,), generator=gen, dtype=torch.int32).to(cuda)
    kern = type(batch)(*(t.clone() for t in batch))
    for _ in range(12):
        turbo_step(eng.tables, kern, 2)
        turbo_step_reference(eng.tables, batch, 2)
        torch.cuda.synchronize()
        for k, r in zip(kern, batch):
            assert torch.equal(k, r)


def test_kernel_counts_its_launches(cuda):
    eng = TurboEngine(compile_src(tp.COPY_TYPES), TurboConfig(), device=cuda)
    before = turbo_step.launches, turbo_step_reference.launches
    eng.step_fn(5)(eng.make_batch(5))
    torch.cuda.synchronize()
    assert turbo_step.launches == before[0] + 1
    assert turbo_step_reference.launches == before[1]


# ---------------------------------------------------------------------------
# the brace-scan kernel (csrc/brace_scan.cu) and the general engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ms", [(1, 7), (1, 96), (33, 31), (257, 96),
                                  (1000, 130), (4099, 512), (5, 0)])
def test_brace_scan_kernel_equals_plain(n, ms, cuda):
    """Bit for bit on seeded rows over ``ab{}\\ `` with lengths in
    [-3, MS + 5] (a length past MS counts as MS, a negative one as 0)."""
    import numpy as np
    from interpolation_engine_tpu_torch.ops.brace_scan import (
        brace_scan, brace_scan_reference)
    rng = np.random.default_rng(n * 1000 + ms)
    alphabet = np.frombuffer(b"ab{}\\ ", np.uint8)
    bufs = torch.from_numpy(alphabet[rng.integers(0, 6, (n, ms))]).to(cuda)
    lens = torch.from_numpy(rng.integers(-3, ms + 6, n).astype(
        np.int32)).to(cuda)
    before = brace_scan.launches, brace_scan_reference.launches
    got = brace_scan(bufs, lens)
    want = brace_scan_reference(bufs, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert brace_scan.launches == before[0] + 1
    assert brace_scan_reference.launches == before[1] + 1


GENERAL = tp.general_programs(bench)


@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_engine_cuda_equals_cpu_after_every_launch(name, cuda):
    """The port's general engine on the card (brace-scan kernel) and on the
    CPU (its plain version), through the ring: every field after every
    launch."""
    from interpolation_engine_tpu_torch._shared import io_manager, vm_config
    from interpolation_engine_tpu_torch.vm.driver import DeviceRunner
    cfg = vm_config.VMConfig(max_str=96, max_key=24, n_slots=12,
                             arena_size=1024, pool_size=32, out_size=192,
                             max_subst=6, max_stars=2, max_list=16,
                             max_fix=4)
    compiled = compile_src(GENERAL[name])
    snaps = {}
    for dev in ("cpu", cuda):
        runner = DeviceRunner(compiled, cfg, io_factory=lambda i: (
            io_manager.IOManager(io_manager.ScriptedBackend(["ok"] * 24))),
            device=dev)
        launch, rec = runner.launch, snaps.setdefault(str(dev), [])

        def recorded(batch, k, launch=launch, rec=rec):
            batch = launch(batch, k)
            rec.append(batch.to_numpy())
            return batch
        runner.launch = recorded
        final = runner.run(runner.make_instances(3), inner_steps=16,
                           max_rounds=400)
        assert all(r.status == vm_config.DONE
                   for r in runner.results(final))
    cpu, card = snaps["cpu"], snaps[str(cuda)]
    assert len(cpu) == len(card)
    for k, (a, b) in enumerate(zip(cpu, card)):
        for f in a:
            assert (a[f] == b[f]).all(), (k, f)
