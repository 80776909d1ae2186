"""CPU tests of the benchmark's yardstick (counts, loader, comparison,
control and faults) at tiny sizes:

    python -m pytest bench_torch/tests -q
"""

import hashlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny widths of the test runs; the cells' own sizes run on the card
TINY = {"num_lstm_cell_units": 16, "batch_size": 4, "num_k": 2, "test_k": 2,
        "eval_batch_size": 5}
TINY_PARAMS = {"programs": 16, "warmup_steps": 4, "profile_steps": 2,
               "warmup_batches": 1, "profile_batches": 1,
               "sample_batches": 2}
# the comparison's limits at the tiny widths, where Adam's rounding and the
# BatchNorm statistics of 4-row batches read higher than at the cells' own
# sizes (CPU readings: sound runs under a third of each, the TF32 control
# over grad_gap's, every planted fault over one of them)
TRAIN_TINY_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4,
                     "grad_gap_median": 1e-5, "change_gap": 2e-2}
TINY_LIMITS = {**TRAIN_TINY_LIMITS,
               **{"late_" + k: v for k, v in TRAIN_TINY_LIMITS.items()},
               "greedy_loss_gap": 1e-5, "token_mismatches": 0,
               "verdict_mismatches": 0, "syntax_mismatches": 0}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_checkpoint(cfg, path):
    """A random checkpoint of cfg's model with batch-norm statistics, as
    the configuration's `checkpoint` entry."""
    from bench_torch.harness import weights
    from bench_torch.reference import karel_model as ref

    w = weights.make(ref.param_specs(cfg), 5, "cpu")
    g = torch.Generator().manual_seed(3)
    for n in list(w):
        if n.endswith("bn.weight"):
            base = n[:-len("weight")]
            w[base + "running_mean"] = 0.1 * torch.randn(w[n].shape,
                                                         generator=g)
            w[base + "running_var"] = 1 + torch.rand(w[n].shape, generator=g)
            w[base + "num_batches_tracked"] = torch.tensor(0)
    torch.save(w, path)
    return {"file": str(path),
            "sha256": hashlib.sha256(Path(path).read_bytes()).hexdigest()}


@pytest.fixture
def tiny_ctx(tmp_path):
    """-> make(cell, seed=...) -> a Context of `cell` at the tiny sizes on
    the CPU, with a tiny checkpoint for an eval cell."""
    from bench_torch.harness.bench import Context

    def make(cell, seed=2 ** 40 + 17, trace=0):
        ctx = Context(cell, seed, 1.0, trace, "cpu", config_override=TINY)
        # a tiny pool is not the cell's: its digest is not checked
        ctx.params = {k: v for k, v in dict(ctx.params, **TINY_PARAMS).items()
                      if k != "pool_sha256"}
        ctx.limits = {k: TINY_LIMITS[k] for k in ctx.limits}
        if "checkpoint" in ctx.config:
            ctx.config["checkpoint"] = tiny_checkpoint(
                ctx.config, tmp_path / "tiny.pt")
        return ctx
    return make
