"""The control (the plain reference in TF32, in the program's place) reads
far above sound runs of the program, at tiny sizes on the CPU; on the card
the same readings, at each cell's own size, set the limits
(bench_torch/tools/readings.py)."""

import sys

import pytest

from bench_torch.harness.bench import ROOT

sys.path.insert(0, str(ROOT / "bench_torch" / "tools"))
import readings  # noqa: E402


@pytest.mark.parametrize("cell", ["karel_full-train",
                                  "karel_synthesis-train"])
def test_train_control_fails_where_the_program_passes(cell, tiny_ctx):
    ctx = tiny_ctx(cell)
    res = readings.train_readings(ctx, ["program", "control"])
    prog, ctrl = res["program"], res["control"]
    assert all(prog[k] <= ctx.limits[k] for k in ctx.limits), prog
    assert ctrl["loss_gap"] > 3 * prog["loss_gap"]
    # the control fails a number the cell compares
    assert any(ctrl[k] > ctx.limits[k] for k in ctx.limits), ctrl


def test_eval_control_fails_where_the_program_passes(tiny_ctx):
    ctx = tiny_ctx("karel_synthesis-eval")
    res = readings.eval_readings(ctx, ["program", "control", "token"])
    prog, ctrl = res["program"], res["control"]
    assert all(prog[k] <= ctx.limits[k] for k in ctx.limits), prog
    assert ctrl["loss_gap"] > 3 * max(prog["loss_gap"], 1e-9)
    assert res["token"]["token_mismatches"] > ctx.limits["token_mismatches"]
