"""Synthesis baseline of the PyTorch port vs the JAX module, on the CPU.

Built like tests/test_torch_models.py and tests/test_torch_train.py: the
tiny config of __graft_entry__._tiny_cfg (k=3, test_k=2, T=6, L=12), flax
variables drawn with numpy and loaded with models/convert.py and
load_state_dict(strict=True), the same numpy batch on both sides. Outputs
at atol 1e-4, greedy ids and lengths exact; the train step against the
jitted JAX `make_step_fn` over 1 and 3 steps; a drive of both CLIs.
"""

import dataclasses

import pytest
import torch

from __graft_entry__ import _tiny_cfg
from demo2program_tpu_torch.data.karel_memory import generate_split
from demo2program_tpu_torch.models.common import ModelConfig
from demo2program_tpu_torch.models.synthesis import SynthesisModel
from tests.test_torch_decode import (
    decode_forward_parity, scheduled_forward_parity)
from tests.test_torch_models import (
    count_lstm_steps, family_batch, family_forward_parity)
from tests.test_torch_train import (
    N_STEPS, SPLIT, check_params_and_bn_statistics,
    check_reports_and_gradients, run_train_parity)
from tests.test_torch_trainer import drive_clis, log_records  # noqa: F401

MODEL = "synthesis_baseline"
# (cell_impl, demo_aggregation): both LSTM layouts, every aggregation
VARIANTS = [("pallas_jnp", "avgpool"), ("xla", "avgpool"),
            ("xla", "maxpool"), ("xla", "concat")]


@pytest.mark.parametrize("cell_impl,aggregation", VARIANTS)
def test_eval_forward_matches_jax(cell_impl, aggregation):
    family_forward_parity(MODEL, train=False, cell_impl=cell_impl,
                          demo_aggregation=aggregation)


@pytest.mark.parametrize("cell_impl,aggregation",
                         [VARIANTS[0], VARIANTS[3]])
def test_train_forward_matches_jax(cell_impl, aggregation):
    family_forward_parity(MODEL, train=True, cell_impl=cell_impl,
                          demo_aggregation=aggregation)


def test_lstm_steps_per_forward(monkeypatch):
    """T + L steps in a train forward (encoder, teacher-forced program),
    T + 2L in an eval forward (and the greedy program): the counts
    chip_smoke.py holds the kernel's launches to."""
    cfg = ModelConfig(**dataclasses.asdict(
        dataclasses.replace(_tiny_cfg(), model=MODEL)))
    model, batch = SynthesisModel(cfg), family_batch(cfg)
    T, L = cfg.max_demo_len, cfg.max_program_len
    assert count_lstm_steps(monkeypatch, model, batch, False) == T + L
    assert count_lstm_steps(monkeypatch, model, batch, True) == T + 2 * L


def _build(value):
    cfg = dataclasses.replace(_tiny_cfg(), model=MODEL, compute_dtype=value)
    return SynthesisModel(ModelConfig(**dataclasses.asdict(cfg)))


@pytest.mark.parametrize("value,raises", [("bfloat16", False),
                                          ("float16", True)])
def test_compute_dtype_options(value, raises):
    """The model builds for bf16 compute (its parameters stay f32: the step
    casts copies, train/step.py:compute_call) and refuses a dtype that
    `--compute_dtype` does not offer."""
    if raises:
        with pytest.raises(ValueError, match="compute_dtype"):
            _build(value)
        return
    model = _build(value)
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("mode", ["beam", "syntax_greedy", "syntax_sample"])
def test_decode_modes_match_jax(mode, monkeypatch):
    """Beam, syntax-constrained greedy and syntax_sample (on JAX's draws)
    decoding through the model vs the JAX module
    (tests/test_torch_decode.py:decode_forward_parity)."""
    decode_forward_parity(MODEL, mode, monkeypatch)


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_scheduled_sampling_matches_jax(p):
    """A train forward with scheduled sampling on JAX's draws: the sampled
    ids exact (tests/test_torch_decode.py:scheduled_forward_parity)."""
    scheduled_forward_parity(MODEL, p)


@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module", params=["pallas", "xla"])
def train_runs(request, split):
    return run_train_parity(split, MODEL, request.param,
                            {"demo_aggregation": "concat"})


def test_train_step_reports_and_gradients_match_jax(train_runs):
    check_reports_and_gradients(train_runs)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_params_and_bn_statistics_match_jax(train_runs, n_steps):
    check_params_and_bn_statistics(train_runs, n_steps)


def test_clis_train_and_evaluate(split, tmp_path, monkeypatch, log_records):
    train_dir, report = drive_clis(MODEL, split, tmp_path, monkeypatch,
                                   log_records)
    assert {"program_loss", "greedy_program_loss"} <= set(report["Loss"])
    assert {"greedy_program_syntax_acc", "greedy_exact_program_accuracy",
            "program_token_acc"} <= set(report["Acc"])
    assert not any("action" in k for d in report.values() for k in d)
    assert "greedy: " in open(f"{train_dir}/samples.txt").read()
