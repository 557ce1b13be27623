"""The one seam to the CUDA library (``ops/build.py`` ``call`` and
``launch``) and the launch counters in ``EVENTS``, on the CPU: each kernel
wrapper on CPU tensors runs its plain version once, counted as
``plain.<name>``, and counts no ``kernel.*``; a nonzero return of an entry
point raises with its name and the CUDA error string, and is not counted
as a launch."""

import functools

import pytest
import torch

import torch_programs as tp
from torch_helpers import port_engine

from interpolation_engine_tpu_torch.core.events import EVENTS
from interpolation_engine_tpu_torch.ops import brace_scan as scan
from interpolation_engine_tpu_torch.ops import build
from interpolation_engine_tpu_torch.ops import filter_kernel as fk
from interpolation_engine_tpu_torch.ops import match_kernel as mk
from interpolation_engine_tpu_torch.ops import math_kernel as mak
from interpolation_engine_tpu_torch.ops import turbo_step as ts


def rows(*texts: bytes):
    width = max(8, *map(len, texts))
    buf = torch.zeros((len(texts), width), dtype=torch.uint8)
    for r, t in enumerate(texts):
        buf[r, :len(t)] = torch.tensor(list(t), dtype=torch.uint8)
    return buf, torch.tensor([len(t) for t in texts], dtype=torch.int32)


def turbo(k_steps=None):
    eng = port_engine(tp.COPY_TYPES)
    batch = eng.make_batch(2)
    if k_steps is None:
        return eng.tables, batch.regs
    return eng.tables, batch, k_steps


# each kernel's wrapper, and its arguments on the CPU
CASES = {
    "turbo_step": lambda: (ts.turbo_step, turbo(k_steps=2)),
    "regroup": lambda: (ts.regroup, turbo()),
    "brace_scan": lambda: (scan.brace_scan, rows(b"{a}", b"x")),
    "chat_filter": lambda: (functools.partial(
        fk.filter_chat_text, start="<o>", stop="</o>", hide_start="",
        hide_stop="", enumerate_outputs=False), rows(b"<o>a</o>")),
    "eval_flat": lambda: (mak.eval_flat, rows(b"1+2", b"3*4")),
    "eval_enum_minmax": lambda: (mak._eval_enum_minmax, (
        *rows(b"1,5", b"2"), torch.tensor([True, False]))),
    "wildcard_match": lambda: (mk.wildcard_match, (
        *rows(b"a*c"), *rows(b"abc", b"xbc"), 2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_plain_version_counts_itself_once(name):
    """One call of a kernel's wrapper on CPU tensors is one call of its
    plain version, and no kernel launch."""
    fn, args = CASES[name]()
    with EVENTS.recording() as rec:
        fn(*args)
    assert rec.counters[f"plain.{name}"] == 1
    assert not [k for k in rec.counters if k.startswith("kernel.")]


class StandIn:
    """A library whose one entry point returns ``rc``."""

    def __init__(self, rc: int):
        self.rc, self.args = rc, []

    def turbo_step_launch(self, *args):
        self.args.append(args)
        return self.rc

    @staticmethod
    def turbo_error_string(rc: int) -> bytes:
        return f"error string {rc}".encode()


@pytest.mark.parametrize("rc", [0, 2, 719])
def test_call_raises_with_the_entry_points_name_and_error(rc, monkeypatch):
    lib = StandIn(rc)
    monkeypatch.setattr(build, "load", lambda: lib)
    with EVENTS.recording() as rec:
        if rc:
            for fn, args in ((build.call, ("turbo_step_launch",)),
                             (build.launch, ("turbo_step",))):
                with pytest.raises(RuntimeError, match=(
                        f"^turbo_step_launch failed: CUDA error {rc} "
                        rf"\(error string {rc}\)$")):
                    fn(*args, 1, "x")
        else:
            assert build.call("turbo_step_launch", 1, "x") is None
            build.launch("turbo_step", 1, "x")
    assert lib.args == [(1, "x")] * 2
    assert rec.counters == ({} if rc else {"kernel.turbo_step": 1})
