"""Induction baseline of the PyTorch port vs the JAX module, on the CPU.

Built like tests/test_torch_models.py and tests/test_torch_train.py: the
tiny config of __graft_entry__._tiny_cfg (k=3, test_k=2, T=6), flax
variables drawn with numpy and loaded with models/convert.py and
load_state_dict(strict=True), the same numpy batch on both sides, with
ragged seen and unseen demos. The weights are random, so the two summaries
the decoder starts from differ (h_sum != c_sum) and the swapped start
(c <- h_sum, h <- c_sum) shows in the outputs.

Outputs at atol 1e-4 with greedy ids and lengths exact, for both LSTM
layouts and every variant: bilstm, luong_monotonic, concat and maxpool
aggregation, state_encoder_fc, concat_state_feature_direct_prediction,
stack_subsequent_state and pixel_input. The train step against the jitted
JAX `make_step_fn` over 1 and 3 steps; a drive of both CLIs, whose eval
reports action accuracies and no program ones.
"""

import dataclasses

import pytest
import torch

from __graft_entry__ import _tiny_cfg
from demo2program_tpu_torch.data.karel_memory import generate_split
from demo2program_tpu_torch.eval.scorer import KarelScorer
from demo2program_tpu_torch.models.common import ModelConfig
from demo2program_tpu_torch.models.induction import InductionModel
from demo2program_tpu_torch.models.ops import init_parameters
from demo2program_tpu_torch.train.device_cache import KarelDeviceCache
from tests.test_torch_models import (
    _tensors, count_lstm_steps, family_batch, family_forward_parity)
from tests.test_torch_train import (
    N_STEPS, SPLIT, check_params_and_bn_statistics,
    check_reports_and_gradients, run_train_parity)
from tests.test_torch_trainer import drive_clis, log_records  # noqa: F401

MODEL = "induction_baseline"
VARIANTS = {
    "pallas_jnp": {"cell_impl": "pallas_jnp"},
    "xla": {"cell_impl": "xla"},
    "bilstm": {"encoder_rnn_type": "bilstm"},
    "monotonic": {"attn_type": "luong_monotonic"},
    "concat": {"demo_aggregation": "concat"},
    "maxpool": {"demo_aggregation": "maxpool"},
    "state_encoder_fc": {"state_encoder_fc": True},
    "concat_state_feature": {"concat_state_feature_direct_prediction": True},
    "stack_subsequent_state": {"stack_subsequent_state": True},
    "pixel_input": {"pixel_input": True},
}


def _cfg(**overrides):
    return ModelConfig(**dataclasses.asdict(
        dataclasses.replace(_tiny_cfg(), model=MODEL, **overrides)))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_jax(variant):
    family_forward_parity(MODEL, train=False, **VARIANTS[variant])


@pytest.mark.parametrize("variant", ["pallas_jnp", "bilstm",
                                     "state_encoder_fc"])
def test_train_forward_matches_jax(variant):
    """Train mode: BatchNorm over the bs*k*T frames on batch statistics,
    the running statistics moved as flax moves them."""
    family_forward_parity(MODEL, train=True, **VARIANTS[variant])


@pytest.mark.parametrize("variant,seen_steps,encoder_passes", [
    ("xla", 6, 1), ("bilstm", 6, 2), ("stack_subsequent_state", 5, 1)])
def test_lstm_steps_per_forward(monkeypatch, variant, seen_steps,
                                encoder_passes):
    """T + T_a steps in a train forward (the seen demos' encoder and the
    teacher-forced test actions; 2T + T_a with bilstm, one step fewer per
    pass with stacked state pairs), T + 2 T_a in an eval forward (and the
    greedy actions): the counts chip_smoke.py holds the kernel's launches
    to. T_a is the width of the test demos' action rows."""
    cfg = _cfg(**VARIANTS[variant])
    model, batch = InductionModel(cfg), family_batch(cfg)
    enc = encoder_passes * seen_steps
    t_a = batch["test_a_h_tokens"].shape[2]
    assert count_lstm_steps(monkeypatch, model, batch, False) == enc + t_a
    assert count_lstm_steps(monkeypatch, model, batch, True) == enc + 2 * t_a


@pytest.mark.parametrize("value,raises", [("bfloat16", False),
                                          ("float16", True)])
def test_compute_dtype_options(value, raises):
    """The model builds for bf16 compute (its parameters stay f32: the step
    casts copies, train/step.py:compute_call) and refuses a dtype that
    `--compute_dtype` does not offer."""
    if raises:
        with pytest.raises(ValueError, match="compute_dtype"):
            InductionModel(_cfg(compute_dtype=value))
        return
    model = InductionModel(_cfg(compute_dtype=value))
    assert {p.dtype for p in model.parameters()} == {torch.float32}


def test_scheduled_sampling_is_ignored():
    """The induction baseline decodes no program: scheduled sampling is
    accepted and changes nothing, as in the JAX module
    (demo2program_tpu/models/induction.py:159-160). A train forward of a
    scheduled-sampling config matches JAX's, and the port's outputs with
    a sampling probability and draws equal those without."""
    model = family_forward_parity(MODEL, train=True, scheduled_sampling=True)
    batch = _tensors(family_batch(model.cfg))
    with torch.no_grad():
        want = model.train()(batch, include_greedy=False)
        got = model.train()(batch, include_greedy=False, sampling_prob=1.0,
                            generator=torch.Generator().manual_seed(1))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_init_parameters_draws_every_parameter_from_the_seed():
    """init_parameters re-draws every parameter from its generator, the
    `manipulation` embedding (flax's uniform: U[0, 0.02)) among them: two
    models drawn from one seed are equal, from another seed they differ
    wherever the initializer is random."""
    models = [InductionModel(_cfg()) for _ in range(3)]
    for model, seed in zip(models, (0, 0, 1)):
        init_parameters(model, torch.Generator().manual_seed(seed))
    emb = models[0].manipulation.embedding
    assert emb.min() >= 0 and emb.max() < 0.02
    a, b, c = (dict(m.named_parameters()) for m in models)
    for name, p in a.items():
        assert torch.equal(p, b[name]), name
        if p.std() > 0:  # not a constant initializer (biases, BN scale)
            assert not torch.equal(p, c[name]), name


def test_unknown_attention_raises():
    with pytest.raises(ValueError, match="attn_type"):
        InductionModel(_cfg(attn_type="bahdanau"))


@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module", params=[
    ("pallas", {}),
    ("xla", {"encoder_rnn_type": "bilstm", "demo_aggregation": "concat"}),
    ("xla", {"attn_type": "luong_monotonic"})],
    ids=["pallas", "xla-bilstm-concat", "xla-monotonic"])
def train_runs(request, split):
    cell_impl, overrides = request.param
    return run_train_parity(split, MODEL, cell_impl, overrides)


def test_train_step_reports_and_gradients_match_jax(train_runs):
    check_reports_and_gradients(train_runs)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_params_and_bn_statistics_match_jax(train_runs, n_steps):
    check_params_and_bn_statistics(train_runs, n_steps)


def test_device_cache_keeps_the_test_demos(split):
    """With include_test (the induction baseline's trainer) a gathered batch
    is all of get_batch_compact but the ids, test_* arrays included."""
    cache = KarelDeviceCache(split, "cpu", 4, seed=1, include_test=True)
    idx = cache.indices(2).tolist()
    want = split.get_batch_compact([split.ids[i] for i in idx])
    got = cache.batch(2)
    assert set(got) == set(want) - {"id"}
    assert any(k.startswith("test_") for k in got)
    for k, v in got.items():
        assert (v.numpy() == want[k]).all(), k


def test_clis_train_and_evaluate(split, tmp_path, monkeypatch, log_records):
    """The trainer keeps the test demos on its device cache and writes no
    program samples; the evaler runs neither the VM nor the syntax scorer
    and reports the action scalars only."""

    def no_scoring(*args, **kwargs):
        raise AssertionError("the induction eval must not score programs")

    monkeypatch.setattr(KarelScorer, "score_batch", no_scoring)
    train_dir, report = drive_clis(MODEL, split, tmp_path, monkeypatch,
                                   log_records)
    assert set(report["Loss"]) == {"loss", "avg_action_loss",
                                   "greedy_avg_action_loss"}
    assert set(report["Acc"]) == {
        "avg_action_token_acc", "avg_action_seq_acc",
        "avg_action_seq_all_acc", "greedy_avg_action_token_acc",
        "greedy_avg_action_seq_acc", "greedy_avg_action_seq_all_acc"}
    assert not (tmp_path / "train" / "samples.txt").exists()
