"""The port's training path vs the JAX package's, on the CPU.

Same numpy inputs on both sides; flax variables move across with
models/convert.py:flax_to_state_dict. The JAX side runs as its own tests do
on the CPU: `cell_impl="pallas"` in interpret mode, and "xla" (per-gate
leaves, folded by the same converter before they are compared: the fold
only reorders, and Adam is elementwise).

Covered: the LSTM step's autograd Function against jax.grad through the
Pallas step; train-mode BatchNorm against flax's; global-norm clipping and
the staircase schedule against optax; the scheduled-sampling probability;
and the whole jitted JAX train step (`make_step_fn`) against the port's
over 1 and 3 steps, with and without scheduled sampling (on the JAX step's
own draws, tests/test_torch_decode.py:scheduled_noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from demo2program_tpu.models import objective as jax_objective
from demo2program_tpu.models.common import ModelConfig as JaxConfig
from demo2program_tpu.models.ops import BNAct as JaxBNAct
from demo2program_tpu.models.registry import (
    get_model_class as jax_model_class)
from demo2program_tpu.ops import pallas_lstm
from demo2program_tpu.ops.reconstruct import expand_batch as jax_expand
from demo2program_tpu.train.step import (
    _cast_floats, _sampling_prob, create_train_state, make_optimizer,
    make_step_fn)
from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.models.full import FullModel
from demo2program_tpu_torch.models.ops import BNAct
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops import fused_lstm
from demo2program_tpu_torch.ops.fused_lstm import fused_lstm_step
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.train.step import (
    TrainState, clip_by_global_norm_, global_norm, learning_rate_at,
    make_train_step, sampling_prob, to_device)
from tests.test_torch_decode import scheduled_noise

BS, N_STEPS, LR, ADAM_EPS = 4, 3, 1e-3, 1e-8
SPLIT = SplitConfig(num_programs=BS * N_STEPS, seed=5, k=3, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)
PER_EMBED_BIAS = "per_decoder.per_embed.dense.bias"


# -- the LSTM step's gradient ------------------------------------------------

@pytest.mark.parametrize("D,H", [(48, 64), (13, 100)])
@pytest.mark.parametrize("B", [3, 32])
def test_step_gradients_match_jax(B, D, H):
    """d(h', c') / d(x, h, c, W, b) of the port's step under autograd (on the
    CPU: the plain forward, then FusedLSTMStep's recomputing backward) vs
    jax.grad through the Pallas step in interpret mode, whose custom VJP
    differentiates `_lstm_step_ref`. atol 1e-5: f32 sums in other orders."""
    r = np.random.RandomState(B + D + H)
    arrays = [r.randn(B, D), r.randn(B, H), r.randn(B, H),
              0.1 * r.randn(D + H, 4 * H), 0.1 * r.randn(4 * H)]
    arrays = [a.astype(np.float32) for a in arrays]
    dh, dc = (r.randn(B, H).astype(np.float32) for _ in range(2))

    def jax_objective_fn(x, h, c, w, b):
        h_new, c_new = pallas_lstm.fused_lstm_step(x, h, c, w, b, True)
        return jnp.sum(h_new * dh) + jnp.sum(c_new * dc)

    want = jax.grad(jax_objective_fn, argnums=(0, 1, 2, 3, 4))(*arrays)
    inputs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    h_new, c_new = fused_lstm_step(*inputs)
    assert h_new.grad_fn.name() == "FusedLSTMStepBackward"
    got = torch.autograd.grad(
        (h_new, c_new), inputs, (torch.from_numpy(dh), torch.from_numpy(dc)))
    for name, g, w in zip("xhcWb", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


# -- BatchNorm in train mode ---------------------------------------------------

@pytest.mark.parametrize("spatial", [False, True])
def test_batch_norm_train_matches_flax(spatial):
    """BNAct in train mode (lrelu, then BN on batch statistics) vs flax
    BNAct(train=True) with mutable batch_stats: the output, its gradients,
    and the updated running mean and var (momentum 0.9, biased variance), at
    atol 1e-5. torch's stock BatchNorm moves running_var by the unbiased
    variance: at these row counts (48, and 4 x 4 x 4 = 64 per channel) that
    misses flax's by about 2e-3, which the last check shows."""
    r = np.random.RandomState(7 + spatial)
    C = 6
    shape = (4, 4, 4, C) if spatial else (48, C)  # flax layout, C last
    x = (1.5 * r.randn(*shape) + 0.3).astype(np.float32)
    dy = r.randn(*shape).astype(np.float32)
    scale, bias = (1 + 0.1 * r.randn(C)), 0.1 * r.randn(C)
    mean, var = 0.5 * r.randn(C), r.uniform(0.5, 2.0, C)
    scale, bias, mean, var = (a.astype(np.float32)
                              for a in (scale, bias, mean, var))
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}
    flax_bn = JaxBNAct(train=True)

    def apply(xv, params):
        return flax_bn.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             xv, mutable=["batch_stats"])

    y_j, upd = apply(x, variables["params"])
    gx_j, gp_j = jax.grad(
        lambda xv, p: jnp.sum(apply(xv, p)[0] * dy), argnums=(0, 1))(
            x, variables["params"])
    stats_j = upd["batch_stats"]["BatchNorm_0"]

    def to_torch_layout(a):  # NHWC -> NCHW
        t = torch.from_numpy(np.array(a))
        return t.permute(0, 3, 1, 2) if spatial else t

    bn_act = BNAct(C, "lrelu", spatial=spatial)
    bn = bn_act.bn
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    xt = to_torch_layout(x).requires_grad_()
    y_t = bn_act.train()(xt)
    y_t.backward(to_torch_layout(dy))

    def close(got, want, what):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0, err_msg=what)

    close(y_t, to_torch_layout(np.asarray(y_j)), "output")
    close(xt.grad, to_torch_layout(np.asarray(gx_j)), "d/dx")
    close(bn.weight.grad, gp_j["BatchNorm_0"]["scale"], "d/dscale")
    close(bn.bias.grad, gp_j["BatchNorm_0"]["bias"], "d/dbias")
    close(bn.running_mean, stats_j["mean"], "running mean")
    close(bn.running_var, stats_j["var"], "running var")

    stock = torch.nn.BatchNorm2d(C) if spatial else torch.nn.BatchNorm1d(C)
    stock = stock.train()
    stock.momentum, stock.eps = 0.1, bn.eps
    stock.running_var.copy_(torch.from_numpy(var))
    with torch.no_grad():
        stock(to_torch_layout(np.asarray(
            0.6 * x + 0.4 * np.abs(x))))  # lrelu(x), leak 0.2
    miss = np.abs(stock.running_var.numpy() - stats_j["var"]).max()
    assert 5e-4 < miss < 1e-2, miss


# -- optimizer pieces ----------------------------------------------------------

@pytest.mark.parametrize("norm", [5.0, 20.0, 80.0])
def test_clip_matches_optax(norm):
    """clip_by_global_norm_ == optax.clip_by_global_norm(20): unchanged
    below 20, (g / norm) * 20 otherwise."""
    r = np.random.RandomState(int(norm))
    grads = [r.randn(*s).astype(np.float32) for s in ((7, 5), (11,), (3,))]
    s = norm / np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [(g * s).astype(np.float32) for g in grads]
    tx = optax.clip_by_global_norm(20.0)
    want, _ = tx.update(grads, tx.init(grads))
    tensors = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = global_norm(tensors)
    np.testing.assert_allclose(float(got_norm),
                               float(optax.global_norm(grads)), rtol=1e-6)
    clip_by_global_norm_(tensors, got_norm)
    for g, w in zip(tensors, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("count", [0, 9999, 10000, 20000])
def test_staircase_schedule_matches_optax(count):
    """The rate of the update after `count` updates == optax
    exponential_decay(1e-3, 10000, 0.5, staircase=True)(count); the train
    state sets it from its step (the count is set, not run)."""
    want = float(optax.exponential_decay(LR, 10000, 0.5,
                                         staircase=True)(count))
    assert learning_rate_at(LR, count, True) == pytest.approx(want,
                                                              rel=1e-6)
    assert learning_rate_at(LR, count, False) == LR
    state = TrainState(torch.nn.Linear(2, 1), LR, lr_weight_decay=True)
    state.step = count
    state.apply_gradients()
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        want, rel=1e-6)
    assert state.step == count + 1


@pytest.mark.parametrize("step", [0, 1, 7, 10, 20, 35])
def test_sampling_prob_matches_jax(step):
    """1 - (1 + (0.1 - 1) * min(step / decay, 1)) in float32, as the JAX
    step computes it from its step counter (decay 20 here)."""
    cfg = JaxConfig(scheduled_sampling_decay_steps=20)
    want = float(_sampling_prob(cfg, jnp.asarray(step, jnp.int32)))
    assert sampling_prob(cfg, step) == want


# -- the train step ------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


def _train_batches(split, include_test=False):
    """The compact batches the device cache serves: no ids, and the test_*
    arrays only with `include_test` (the induction baseline's cache)."""
    out = []
    for s in range(N_STEPS):
        b = split.get_batch_compact(split.ids[s * BS:(s + 1) * BS])
        out.append({k: v for k, v in b.items() if k != "id" and (
            include_test or not k.startswith("test_"))})
    return out


def _random_stats(tree, seed=0):
    """Random BN running statistics, so the momentum update shows."""
    r = np.random.RandomState(seed)

    def draw(path, a):
        if "'var'" in jax.tree_util.keystr(path):
            return r.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return (0.5 * r.randn(*a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def run_train_parity(split, model_name, cell_impl, overrides=None,
                     start_step=0, batches=None, extra_flags=()):
    """N_STEPS steps of the jitted JAX `make_step_fn` and of the port's
    train step of `model_name` from the same variables (JAX's initializers,
    random BN running statistics) on the same batches (default: the
    device cache's compact batches of `split`); `overrides` replace config
    fields that have no flag, `extra_flags` are trainer flags. Both step
    counters start at `start_step` (it sets the scheduled-sampling
    probability; Adam keeps its own count). With scheduled sampling the
    port draws what the JAX step draws from its key. -> dict with the JAX
    gradients of step 1 and, per step, both reports, the port's gradients
    and both state_dicts."""
    args = trainer_cli.parse_args([
        "--device", "cpu", "--model", model_name, "--num_k", str(SPLIT.k),
        "--batch_size", str(BS), "--num_lstm_cell_units", "32",
        "--cell_impl", cell_impl, "--learning_rate", str(LR), *extra_flags])
    cfg = dataclasses.replace(config_from_dataset(args, split),
                              **(overrides or {}))
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jmodel = jax_model_class(model_name)(jcfg, train=True)
    tx = make_optimizer(jcfg, LR)
    batches = batches or _train_batches(
        split, include_test=model_name == "induction_baseline")
    state = jax.jit(lambda b: create_train_state(
        jmodel, jcfg, tx, jax.random.key(0), b))(batches[0])
    state = state.replace(batch_stats=_random_stats(state.batch_stats),
                          step=jnp.asarray(start_step, jnp.int32))
    key = jax.random.key(1)
    ss = {}
    if cfg.scheduled_sampling:
        ss = dict(sampling_prob=_sampling_prob(jcfg, state.step), rng=key)

    def loss_fn(params, batch):
        b = jax_expand(batch, jcfg)
        variables, cast = {"params": params,
                           "batch_stats": state.batch_stats}, b
        if cfg.compute_dtype == "bfloat16":  # as make_step_fn casts
            variables, cast = (_cast_floats(t, jnp.bfloat16)
                               for t in (variables, b))
        out, _ = jmodel.apply(variables, cast, mutable=["batch_stats"],
                              include_greedy=False, **ss)
        return jax_objective.compute_loss(jcfg, out, b, model_name)[0]

    grads_j = flax_to_state_dict(
        jax.device_get(jax.jit(jax.grad(loss_fn))(state.params, batches[0])),
        state.batch_stats)
    step_j = jax.jit(make_step_fn(jmodel, jcfg, tx, model_name))

    model = get_model_class(model_name)(cfg)
    model.load_state_dict(flax_to_state_dict(state.params,
                                             state.batch_stats))
    train_state = TrainState(model, LR)
    train_state.step = start_step
    step_t = make_train_step(train_state, cfg, model_name)
    noise = None
    if cfg.scheduled_sampling:
        noise = tuple(torch.from_numpy(n) for n in scheduled_noise(
            key, cfg.max_program_len, BS, cfg.dim_program_token))
    resync = PER_EMBED_BIAS in dict(model.named_parameters())
    steps = []
    for batch in batches:
        # The full model's per_embed Dense bias feeds BatchNorm directly:
        # its gradient is 0 in exact arithmetic, so Adam moves it by
        # rounding noise, and the BN's batch mean (hence running_mean)
        # carries it. Each step starts from the JAX side's value, so the
        # running statistics stay comparable; the bias itself is held to
        # 2 * lr below.
        if resync:
            with torch.no_grad():
                model.get_parameter(PER_EMBED_BIAS).copy_(flax_to_state_dict(
                    state.params, state.batch_stats)[PER_EMBED_BIAS])
        state, rep_j = step_j(state, batch, key)
        rep_t = step_t(to_device(batch, "cpu"), noise=noise)
        steps.append({
            "rep_j": jax.device_get(rep_j), "rep_t": rep_t,
            "grads_t": {n: p.grad.clone()
                        for n, p in model.named_parameters()},
            "sd_j": flax_to_state_dict(jax.device_get(state.params),
                                       jax.device_get(state.batch_stats)),
            "sd_t": {k: v.clone() for k, v in model.state_dict().items()}})
    assert train_state.step == start_step + N_STEPS
    return {"grads_j": grads_j, "steps": steps,
            "params": [n for n, _ in model.named_parameters()]}


def check_reports_and_gradients(runs, grad_rtol=1e-4):
    """Every report scalar at atol 1e-4 and grad_norm (the unclipped
    gradients' global norm) at rtol 1e-4, in each step; every parameter's
    gradient of step 1 within grad_rtol * max|g_leaf| + 1e-7. The full
    model's per_embed Dense bias has a gradient that is mathematically zero
    (about 2e-8 of rounding, against 1e-4 to 1e-2 for its neighbours): it
    is held to atol 1e-7."""
    for s in runs["steps"]:
        rep_j, rep_t = s["rep_j"], s["rep_t"]
        assert set(rep_t) == set(rep_j)
        for k in rep_j:
            if k == "grad_norm":
                np.testing.assert_allclose(float(rep_t[k]), float(rep_j[k]),
                                           rtol=1e-4)
            else:
                np.testing.assert_allclose(float(rep_t[k]), float(rep_j[k]),
                                           atol=1e-4, rtol=0, err_msg=k)
    grads_t = runs["steps"][0]["grads_t"]
    grads_j = runs["grads_j"]
    assert set(grads_t) <= set(grads_j)
    for name, g in grads_t.items():
        want = grads_j[name]
        err = (g - want).abs().max().item()
        bound = (1e-7 if name == PER_EMBED_BIAS
                 else grad_rtol * want.abs().max().item() + 1e-7)
        assert err <= bound, (name, err, bound)


def check_params_and_bn_statistics(runs, n_steps):
    """After n_steps: parameters at atol 1e-5 and BN running statistics at
    atol 1e-5. Adam moves an element by lr * g / (|g| + 1e-8), so where |g|
    is within 100 * eps of zero the step turns gradient rounding into a
    change of up to 2 * lr (the two sides may step either way); such
    elements (|g| < 1e-6 in any step so far, the per_embed bias among them)
    are held to 2 * lr per step."""
    steps = runs["steps"][:n_steps]
    sd_t, sd_j = steps[-1]["sd_t"], steps[-1]["sd_j"]
    assert set(sd_t) == set(sd_j)
    for name in runs["params"]:
        tiny = np.zeros(sd_t[name].shape, bool)
        for s in steps:
            tiny |= s["grads_t"][name].abs().numpy() < 100 * ADAM_EPS
        err = (sd_t[name] - sd_j[name]).abs().numpy()
        assert err[~tiny].max(initial=0.0) <= 1e-5, (name, err[~tiny].max())
        assert err[tiny].max(initial=0.0) <= 2 * LR * n_steps, name
    for name in sd_j:
        if "running_" in name:
            err = (sd_t[name] - sd_j[name]).abs().max().item()
            assert err <= 1e-5, (name, err)


@pytest.fixture(scope="module", params=["pallas", "xla"])
def train_runs(request, split):
    return run_train_parity(split, "full", request.param)


def test_train_step_reports_and_gradients_match_jax(train_runs):
    check_reports_and_gradients(train_runs)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_params_and_bn_statistics_match_jax(train_runs, n_steps):
    check_params_and_bn_statistics(train_runs, n_steps)


@pytest.fixture(scope="module", params=["pallas", "xla"])
def scheduled_runs(request, split):
    """Scheduled sampling over steps 1-3 of a 2-step decay: sampling
    probabilities 0.45, 0.9, 0.9 (step 0's is 0, teacher forcing)."""
    return run_train_parity(
        split, "full", request.param,
        {"scheduled_sampling": True, "scheduled_sampling_decay_steps": 2},
        start_step=1)


def test_scheduled_sampling_reports_and_gradients_match_jax(scheduled_runs):
    """The report (token accuracies from the sampled ids), grad_norm and
    step 1's gradients, within the bounds of the teacher-forced check."""
    check_reports_and_gradients(scheduled_runs)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_scheduled_sampling_params_match_jax(scheduled_runs, n_steps):
    check_params_and_bn_statistics(scheduled_runs, n_steps)


def test_train_mode_model_skips_greedy(split, monkeypatch):
    """include_greedy=False leaves out both greedy decoders: 4T + L LSTM
    steps instead of 5T + 2L. Scheduled sampling takes the same steps and
    reports its sampled ids."""
    args = trainer_cli.parse_args(["--device", "cpu", "--num_k", "3",
                                   "--num_lstm_cell_units", "16"])
    cfg = config_from_dataset(args, split)
    model = FullModel(cfg)
    batch = expand_batch(
        to_device(split.get_batch_compact(split.ids[:2]), "cpu"), cfg)
    calls = []

    def counted(*a):
        calls.append(1)
        return fused_lstm.lstm_step_ref(*a)

    monkeypatch.setattr(fused_lstm, "fused_lstm_step", counted)
    T, L = cfg.max_demo_len, cfg.max_program_len
    for include_greedy, want in ((False, 4 * T + L), (True, 5 * T + 2 * L)):
        calls.clear()
        with torch.no_grad():
            out = model.train()(batch, include_greedy=include_greedy)
        assert len(calls) == want
        assert ("greedy_program_tokens" in out) == include_greedy
    calls.clear()
    with torch.no_grad():
        out = model.train()(batch, include_greedy=False, sampling_prob=0.5,
                            generator=torch.Generator().manual_seed(0))
    assert len(calls) == 4 * T + L
    assert out["pred_program_tokens"].shape == (2, L)
