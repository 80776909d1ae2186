"""bf16 compute (`--compute_dtype bfloat16`) of the port vs the JAX package's,
on the CPU at the tiny config (k=3, T=6, L=12, units 32 or 64).

Both sides get the same numpy inputs and the same f32 variables (converted
with models/convert.py) and cast them as their step does: the JAX side with
`_cast_floats` (demo2program_tpu/train/step.py:67-72), the port with
train/step.py:compute_call. The JAX LSTM cell runs as `pallas` in interpret
mode: gates in f32 on a bf16 matmul accumulated in f32, as the CUDA kernel
computes them. (`pallas_jnp` and flax's own cell, `cell_impl="xla"`, take
their gates in bf16; the port runs the fused cell for every cell_impl, so
whole steps are compared with `pallas` only.)

What can be exact is held exact or to one bf16 ulp (ULP = 2**-7 of the binade):
BatchNorm's stored running statistics, the LSTM cell, single layers. Whole
steps cannot: XLA on the CPU keeps excess precision between fused bf16 ops
and sums in other orders, so two correct bf16 programs differ by bf16
rounding, as far as each lies from the f32 step. The whole-step checks
therefore measure that noise (the JAX bf16 step against the JAX f32 step,
same inputs) and hold the port within it. Readings, full model on Karel,
step 1: loss 6.3974 vs 6.3965 (the f32 step: 6.3969); gradients differ by
1.0e-2 in global norm between the port and JAX, 1.5e-2 between JAX bf16 and
JAX f32; per leaf the port is at most 1.5x the JAX bf16-to-f32 distance
plus 2% of the leaf's largest gradient (conv1's kernel: 8.4e-4 against
1.7e-3; rn_pool fc1's bias: 1.5e-3 against 1.5e-3, largest 6.9e-3).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from __graft_entry__ import _tiny_cfg
from demo2program_tpu.data.vizdoom_generator import (
    VizdoomGeneratorConfig, generate as generate_vizdoom)
from demo2program_tpu.models.common import (
    ModelConfig as JaxConfig, TwoPassDemoEncoder as JaxEncoder)
from demo2program_tpu.models.full import FullModel as JaxFullModel
from demo2program_tpu.models.induction import _AttnDecoderCore
from demo2program_tpu.models.ops import BNAct as JaxBNAct
from demo2program_tpu.models.registry import (
    get_model_class as jax_model_class)
from demo2program_tpu.ops.pallas_lstm import PallasLSTMCell
from demo2program_tpu.ops.reconstruct import expand_batch as jax_expand
from demo2program_tpu.train.step import (
    TrainState as JaxTrainState, _cast_floats, make_eval_step as jax_eval_step)
from demo2program_tpu_torch.cli import evaler_cli, trainer_cli
from demo2program_tpu_torch.data.karel_memory import generate_split
from demo2program_tpu_torch.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu_torch.eval.evaler import Evaler, config_from_dataset
from demo2program_tpu_torch.models.common import ModelConfig, check_ported
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.models.decoder import embed
from demo2program_tpu_torch.models.induction import AttnDecoderCore
from demo2program_tpu_torch.models.ops import BNAct, init_parameters
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops.fused_lstm import FusedLSTMCell
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.step import (
    TrainState, cast_floats, compute_call, make_eval_step, make_train_step,
    to_device)
from demo2program_tpu_torch.train.trainer import Trainer
from tests.test_torch_models import (
    _random_variables, _tensors, family_batch)
from tests.test_torch_train import BS, SPLIT, run_train_parity
from tests.test_torch_trainer import _args as trainer_args
from tests.test_torch_vizdoom_models import _cache_batches

BF16_T = torch.bfloat16
ULP = 2.0 ** -7           # one bf16 ulp, relative to the value's binade
FAMILIES = ("full", "synthesis_baseline", "summarizer", "induction_baseline")
# The JAX induction model cannot run its default variant in bf16: its scan
# carry starts from f32 zeros (demo2program_tpu/models/induction.py:206-209)
# and comes back bf16, which nn.scan refuses. With the state features
# concatenated to the memory the attention is f32 throughout and it runs;
# that variant is what whole steps are compared on. The default variant's
# attention runs in bf16: its one decoder step is held against the JAX
# step module outside nn.scan, on a bf16 carry and memory
# (test_attention_decoder_step_bf16_matches_jax), and its whole step
# against the port's own f32 step (test_induction_default_variant_runs).
JAX_BF16_OVERRIDES = {
    "induction_baseline": {"concat_state_feature_direct_prediction": True}}


def _bf16_tree(tree):
    return _cast_floats(tree, jnp.bfloat16)


def _ulps(got, want, floor=1.0):
    """|got - want| in bf16 ulps, worst element: ulps of `want`'s binade,
    or of `floor` where |want| is smaller (a difference of two rounded
    values carries their ulp, not its own)."""
    got, want = (np.asarray(a, np.float32) for a in (got, want))
    binade = 2.0 ** np.floor(np.log2(np.maximum(np.abs(want), floor)))
    return float((np.abs(got - want) / (binade * ULP)).max())


def _np(t):
    return t.detach().float().numpy()


# -- (a) BatchNorm ---------------------------------------------------------------

def _bn_case(seed, spatial, x_dtype):
    r = np.random.RandomState(seed)
    C = 6
    shape = (4, 4, 4, C) if spatial else (48, C)
    x = (1.5 * r.randn(*shape) + 0.3).astype(np.float32)
    leaves = {"scale": 1 + 0.1 * r.randn(C), "bias": 0.1 * r.randn(C),
              "mean": 0.5 * r.randn(C), "var": r.uniform(0.5, 2.0, C)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    x_j = jnp.asarray(x).astype(x_dtype)
    x_t = torch.from_numpy(x)
    x_t = x_t.permute(0, 3, 1, 2) if spatial else x_t
    x_t = x_t.to(BF16_T if x_dtype == jnp.bfloat16 else torch.float32)
    bn_act = BNAct(C, "lrelu", spatial=spatial)
    bn = bn_act.bn
    with torch.no_grad():
        for t, k in ((bn.weight, "scale"), (bn.bias, "bias"),
                     (bn.running_mean, "mean"), (bn.running_var, "var")):
            t.copy_(torch.from_numpy(leaves[k]))
    variables = {
        "params": {"BatchNorm_0": {k: leaves[k] for k in ("scale", "bias")}},
        "batch_stats": {"BatchNorm_0": {k: leaves[k]
                                        for k in ("mean", "var")}}}
    return x_j, x_t, variables, bn_act


def _port_bn(bn_act, x_t):
    params = cast_floats(dict(bn_act.named_parameters()), BF16_T)
    with torch.no_grad():
        y = functional_call(bn_act, params, (x_t,))
    return y.permute(0, 2, 3, 1) if y.dim() == 4 else y


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("spatial", [False, True], ids=["fc", "conv"])
def test_bn_act_train_mode_matches_flax(spatial, x_dtype):
    """Train-mode BNAct on bf16 parameters and bf16-cast running
    statistics, on an f32 input (the state encoders) and a bf16 one: the
    output has flax's dtype (the input's) and value to two bf16 ulps (the
    bf16 lrelu rounds three times before the f32 normalisation; f32 input:
    atol 1e-5), and the STORED running statistics are f32 and equal
    flax's to 1e-6 (bf16 input: 1e-3): 0.9 * f32(bf16(running)) + 0.1 * the f32 batch
    statistic. (flax writes the first product in bf16; XLA on the CPU keeps
    it in f32.) Moving the unrounded f32 running value instead would miss
    by up to 0.9 * half a bf16 ulp of it (3.5e-3 at 1.0), which the last
    check shows."""
    x_j, x_t, variables, bn_act = _bn_case(3 + spatial, spatial, x_dtype)
    y_j, upd = JaxBNAct(train=True).apply(
        _bf16_tree(variables), x_j, mutable=["batch_stats"])
    y_t = _port_bn(bn_act.train(), x_t)
    assert str(y_t.dtype).split(".")[1] == str(y_j.dtype)
    if x_dtype == jnp.bfloat16:
        assert _ulps(_np(y_t), y_j) <= 2
    else:
        np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5,
                                   rtol=0)
    stats_j = upd["batch_stats"]["BatchNorm_0"]
    bn = bn_act.bn
    for got, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        assert got.dtype == torch.float32 and stats_j[key].dtype == np.float32
        # a bf16 input's batch statistic carries the bf16 lrelu's rounding
        np.testing.assert_allclose(
            got.numpy(), np.asarray(stats_j[key]), rtol=0, err_msg=key,
            atol=1e-6 if x_dtype == jnp.float32 else 1e-3)
    old = variables["batch_stats"]["BatchNorm_0"]["var"]
    rounded = np.asarray(jnp.asarray(old).astype(jnp.bfloat16), np.float32)
    miss = np.abs(0.9 * (old - rounded)).max()
    assert 1e-4 < miss < 8e-3, miss


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["x_f32", "x_bf16"])
@pytest.mark.parametrize("spatial", [False, True], ids=["fc", "conv"])
def test_bn_act_eval_mode_matches_flax(spatial, x_dtype):
    """Eval-mode BNAct normalises with the bf16-CAST running statistics in
    the promoted dtype of its input: flax's dtype, its value to one bf16 ulp
    of the output (bf16 input: two, the chain rounds four times and XLA may
    keep excess precision between its ops), and the stored statistics
    untouched."""
    x_j, x_t, variables, bn_act = _bn_case(5 + spatial, spatial, x_dtype)
    y_j = JaxBNAct(train=False).apply(_bf16_tree(variables), x_j)
    before = bn_act.bn.running_var.clone()
    y_t = _port_bn(bn_act.eval(), x_t)
    assert str(y_t.dtype).split(".")[1] == str(y_j.dtype)
    if x_dtype == jnp.bfloat16:
        assert _ulps(_np(y_t), y_j) <= 2
    else:
        np.testing.assert_allclose(_np(y_t), np.asarray(y_j), atol=1e-5,
                                   rtol=0)
    assert torch.equal(bn_act.bn.running_var, before)
    # f32 statistics would differ from the bf16-cast ones visibly
    y_f32 = JaxBNAct(train=False).apply(
        {"params": _bf16_tree(variables["params"]),
         "batch_stats": variables["batch_stats"]}, x_j)
    assert np.abs(np.asarray(y_f32, np.float32)
                  - np.asarray(y_j, np.float32)).max() > 1e-3


# -- (b) the LSTM cell -----------------------------------------------------------

@pytest.mark.parametrize("impl,ulps", [("pallas", 1), ("pallas_jnp", 4)])
@pytest.mark.parametrize("B,D,H", [(6, 48, 32), (5, 13, 20)])
def test_lstm_cell_bf16_matches_jax(B, D, H, impl, ulps):
    """The cell on bf16 parameters with an f32 carry and an f32 input (the
    encoder's first pass): the new carry is f32 (bf16-rounded values) and
    the output bf16, to one bf16 ulp (of the value, or of 0.25 below that)
    of the Pallas cell in interpret mode, whose gates are f32 on an
    f32-accumulated bf16 matmul like the CUDA kernel's. `pallas_jnp`
    (`_lstm_step_ref` on bf16 arrays) rounds the matmul and every gate to
    bf16: the port runs the kernel's math for it too, 4 ulps away. The f32
    parameters' gradients are f32 and agree within 3% of each leaf's
    largest (bf16 backward on both sides)."""
    r = np.random.RandomState(B + D + H)
    w = (0.3 * r.randn(D + H, 4 * H)).astype(np.float32)
    b = (0.1 * r.randn(4 * H)).astype(np.float32)
    x, h, c = (r.randn(B, n).astype(np.float32) for n in (D, H, H))
    dh, dc = (r.randn(B, H).astype(np.float32) for _ in range(2))
    cell_j = PallasLSTMCell(H, force_jnp=impl == "pallas_jnp")

    def apply_j(params):
        (c1, h1), out = cell_j.apply({"params": _bf16_tree(params)},
                                     (c, h), x)
        return (c1, h1, out)

    params_j = {"kernel": w, "bias": b}
    c_j, h_j, out_j = apply_j(params_j)
    g_j = jax.grad(lambda p: (apply_j(p)[0] * dc).sum()
                   + (apply_j(p)[2].astype(jnp.float32) * dh).sum())(params_j)

    cell = FusedLSTMCell(D, H)
    with torch.no_grad():
        cell.kernel.copy_(torch.from_numpy(w))
        cell.bias.copy_(torch.from_numpy(b))
    params = cast_floats(dict(cell.named_parameters()), BF16_T)
    (c_t, h_t), out_t = functional_call(
        cell, params, ((torch.from_numpy(c), torch.from_numpy(h)),
                       torch.from_numpy(x)))
    assert (c_t.dtype, h_t.dtype, out_t.dtype) == (
        torch.float32, torch.float32, BF16_T)
    assert (c_j.dtype, h_j.dtype, out_j.dtype) == (
        jnp.float32, jnp.float32, jnp.bfloat16)
    for got, want in ((c_t, c_j), (h_t, h_j), (out_t, out_j)):
        assert _ulps(_np(got), want, floor=0.25) <= ulps
    ((c_t * torch.from_numpy(dc)).sum()
     + (out_t.float() * torch.from_numpy(dh)).sum()).backward()
    for got, want in ((cell.kernel.grad, g_j["kernel"]),
                      (cell.bias.grad, g_j["bias"])):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 0.03 * np.abs(want).max()


# -- dtypes through the model ----------------------------------------------------

def _torch_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _dtype_names(tree):
    return {k: str(v.dtype).replace("torch.", "") for k, v in tree.items()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("model_name", FAMILIES)
def test_output_dtypes_match_jax(model_name, train):
    """Every output leaf of every family has the dtype of the JAX module's
    under the bf16 cast (logits bf16, beam/one-hot leaves f32, ids int32):
    the JAX step's cast of the outputs back to float32 moves float32 leaves
    only, so the objective gets these. JAX side by jax.eval_shape."""
    cfg = dataclasses.replace(
        _tiny_cfg(), model=model_name, cell_impl="pallas",
        compute_dtype="bfloat16", **JAX_BF16_OVERRIDES.get(model_name, {}))
    batch = family_batch(cfg)
    jmodel = jax_model_class(model_name)(cfg, train=train)
    variables = _random_variables(jmodel, batch, seed=2)
    out_j = jax.eval_shape(
        lambda v, b: jmodel.apply(_bf16_tree(v), _bf16_tree(b),
                                  include_greedy=not train,
                                  mutable=["batch_stats"])[0],
        variables, batch)
    model = get_model_class(model_name)(_torch_cfg(cfg)).train(train)
    with torch.no_grad():
        out_t = compute_call(model, cfg, _tensors(batch),
                             include_greedy=not train)
    assert _dtype_names(out_t) == _dtype_names(out_j)
    # (the compared induction variant attends in f32: all its logits are)
    assert ("bfloat16" in _dtype_names(out_t).values()) == (
        model_name != "induction_baseline")


def test_encoder_dtypes_match_jax():
    """Inside the two-pass encoder: the CNN runs in f32 on bf16-rounded
    weights, so the first pass's carry, the cross-demo means and the RN
    summaries are f32, while each LSTM's output history is bf16."""
    cfg = dataclasses.replace(_tiny_cfg(), cell_impl="pallas_jnp")
    batch = family_batch(cfg)
    enc_j = JaxEncoder(cfg, train=False, rn_aggregation="rn")
    demo_len = batch["demo_len"].astype(np.int32)
    shapes = jax.eval_shape(lambda: enc_j.init(
        jax.random.key(0), batch["s_h"], demo_len))
    out_j = jax.eval_shape(
        lambda v: enc_j.apply(_bf16_tree(v), jnp.asarray(
            batch["s_h"]).astype(jnp.bfloat16), demo_len), shapes)
    model = get_model_class("full")(_torch_cfg(cfg)).eval()
    enc_t = model.encoder
    with torch.no_grad():
        out_t = functional_call(
            enc_t, cast_floats(dict(enc_t.named_parameters()), BF16_T),
            (torch.from_numpy(batch["s_h"]).to(BF16_T),
             torch.from_numpy(demo_len).long()))
    assert _dtype_names(out_t) == _dtype_names(out_j)
    assert _dtype_names(out_t) == {
        "feature_history": "bfloat16", "demo_h": "float32",
        "demo_c": "float32", "demo_h_summary": "float32",
        "demo_c_summary": "float32"}


# -- (c) one train step per family -------------------------------------------------

@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module")
def vizdoom_split(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vizdoom_bf16") / "d")
    generate_vizdoom(VizdoomGeneratorConfig(
        dir_name=path, num_train=12, num_test=4, num_val=0, seed=7,
        num_demo_per_program=4, num_test_demo_per_program=2))
    return create_vizdoom_splits(path, num_k=SPLIT.k)[0]


def _vizdoom_batches(vz_split):
    """The ViZDoom device cache's batches with seeded random pixels in 0..3
    (on DoomLite's near-uniform frames train-mode BatchNorm is
    ill-conditioned in both packages, tests/test_torch_vizdoom_models.py)."""
    return _cache_batches(vz_split, True)


def _runs(split_, model_name, dtype, batches=None, extra_flags=()):
    overrides = dict(JAX_BF16_OVERRIDES.get(model_name, {}),
                     compute_dtype=dtype)
    return run_train_parity(split_, model_name, "pallas", overrides,
                            batches=batches, extra_flags=extra_flags)


CASES = [("karel", name) for name in FAMILIES] + [("vizdoom", "full")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def train_pair(request, split, vizdoom_split):
    """(bf16 runs, f32 runs) of run_train_parity: three steps of the JAX
    step and the port's from the same variables, in each dtype."""
    domain, model_name = request.param
    kwargs = {}
    split_ = split
    if domain == "vizdoom":
        split_ = vizdoom_split
        kwargs = dict(batches=_vizdoom_batches(vizdoom_split),
                      extra_flags=("--dataset_type", "vizdoom"))
    return (_runs(split_, model_name, "bfloat16", **kwargs),
            _runs(split_, model_name, "float32", **kwargs))


def test_train_step_reports_match_jax(train_pair):
    """Step 1's report: every scalar within 5e-3 + the JAX bf16 step's own
    distance from the JAX f32 step (readings, full model on Karel: loss
    6.3974 / 6.3965 / f32 6.3969; program_loss 3.9063 / 3.9058; avg_per_loss
    0.70147 / 0.70098), the token accuracies within one token of the batch,
    and grad_norm within 2% (0.42793 / 0.42843)."""
    bf16, f32 = train_pair
    rep_t, rep_j = bf16["steps"][0]["rep_t"], bf16["steps"][0]["rep_j"]
    rep_32 = f32["steps"][0]["rep_j"]
    assert set(rep_t) == set(rep_j)
    for k in rep_j:
        got, want, ref = (float(r[k]) for r in (rep_t, rep_j, rep_32))
        assert rep_t[k].dtype == torch.float32 and rep_j[k].dtype == np.float32
        if k == "grad_norm":
            assert abs(got / want - 1) <= 0.02, (k, got, want)
        elif k.endswith("acc"):
            assert abs(got - want) <= 0.1, (k, got, want)
        else:
            assert abs(got - want) <= 5e-3 + abs(want - ref), (k, got, want)


def test_train_step_gradients_match_jax(train_pair):
    """Step 1's gradients, all f32 on both sides: the port's lie as near
    JAX's bf16 gradients as those lie to JAX's own f32 gradients (global
    norm of the difference at most 1.5x), and per leaf within 2x that
    leaf's JAX bf16-to-f32 distance + 3% of its largest gradient."""
    bf16, f32 = train_pair
    g_t, g_j, g_32 = (bf16["steps"][0]["grads_t"], bf16["grads_j"],
                      f32["grads_j"])
    assert {g.dtype for g in g_t.values()} == {torch.float32}

    def dist(a, b):
        return float(torch.sqrt(sum(((a[n] - b[n]) ** 2).sum()
                                    for n in g_t)))

    noise = dist(g_j, g_32)
    assert noise > 0 and dist(g_t, g_j) <= 1.5 * noise, (
        dist(g_t, g_j), noise)
    for n, g in g_t.items():
        err = (g - g_j[n]).abs().max().item()
        bound = (2 * (g_j[n] - g_32[n]).abs().max().item()
                 + 0.03 * g_j[n].abs().max().item() + 1e-7)
        assert err <= bound, (n, err, bound)


def test_train_state_stays_f32_and_tracks_jax(train_pair):
    """After one bf16 step and after three: parameters, BN statistics and
    Adam's moments are f32; parameters within 2 * lr per step of JAX's
    (Adam's first steps are lr * sign(g): a gradient that bf16 rounding
    leaves on either side of zero moves the two sides apart by 2 * lr); BN
    running statistics within one bf16 ulp of the running value per step
    (+ 1e-3: the batch statistic of a bf16 activation)."""
    bf16, _ = train_pair
    lr = 1e-3
    for n_steps in (1, 3):
        sd_t = bf16["steps"][n_steps - 1]["sd_t"]
        sd_j = bf16["steps"][n_steps - 1]["sd_j"]
        assert set(sd_t) == set(sd_j)
        for name, got in sd_t.items():
            want = sd_j[name]
            if not got.dtype.is_floating_point:
                continue
            assert got.dtype == want.dtype == torch.float32, name
            err = (got - want).abs().max().item()
            if "running_" in name:
                bound = n_steps * (ULP * max(1.0, want.abs().max().item())
                                   + 1e-3)
            else:
                bound = 2 * lr * n_steps + 1e-6
            assert err <= bound, (name, n_steps, err, bound)


def test_adam_moments_stay_f32(split):
    args = trainer_cli.parse_args([
        "--device", "cpu", "--num_k", str(SPLIT.k), "--batch_size", str(BS),
        "--num_lstm_cell_units", "32", "--compute_dtype", "bfloat16"])
    cfg = config_from_dataset(args, split)
    model = get_model_class("full")(cfg)
    state = TrainState(model, 1e-3)
    report = make_train_step(state, cfg, "full")(
        to_device(split.get_batch_compact(split.ids[:BS]), "cpu"))
    assert report["loss"].dtype == torch.float32
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        moments = state.optimizer.state[p]
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype \
            == torch.float32
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in model.buffers())


def test_induction_default_variant_runs(split):
    """The induction baseline's default variant in bf16, which the JAX
    module refuses at trace time (JAX_BF16_OVERRIDES): the port starts the
    attention carry in the memory's dtype, so it runs; its loss lies within
    2e-2 of the port's own f32 step from the same weights and its gradients
    within 5% in global norm."""
    with pytest.raises(TypeError, match="carry"):
        _jax_induction_default_bf16()
    losses, grads = {}, {}
    for dtype in ("float32", "bfloat16"):
        args = trainer_cli.parse_args([
            "--device", "cpu", "--model", "induction_baseline",
            "--num_k", str(SPLIT.k), "--batch_size", str(BS),
            "--num_lstm_cell_units", "32", "--compute_dtype", dtype])
        cfg = config_from_dataset(args, split)
        model = get_model_class("induction_baseline")(cfg)
        init_parameters(model, torch.Generator().manual_seed(0))
        state = TrainState(model, 1e-3)
        report = make_train_step(state, cfg, "induction_baseline")(
            to_device(split.get_batch_compact(split.ids[:BS]), "cpu"))
        losses[dtype] = float(report["loss"])
        grads[dtype] = torch.cat([p.grad.flatten()
                                  for p in model.parameters()])
    assert abs(losses["bfloat16"] - losses["float32"]) <= 2e-2, losses
    rel = ((grads["bfloat16"] - grads["float32"]).norm()
           / grads["float32"].norm()).item()
    assert 0 < rel <= 0.05, rel


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("attn_type", ["luong", "luong_monotonic"])
def test_attention_decoder_step_bf16_matches_jax(attn_type, seed):
    """One step of the induction baseline's attention decoder in bf16, the
    part of its default variant that JAX's nn.scan refuses to trace: the
    JAX step module applied on its own to a bf16 carry, memory and keys
    against the port's AttnDecoderCore on the same. Every leaf is bf16 on
    both sides; the LSTM carry is equal, the attention and the logits lie
    within 2 bf16 ulps (of the value, or of 0.25 below that) and the
    alignments within 3 ulps (floor 2^-4): readings over the six cases, 0 /
    0 / 1-2 / 0.6-2 / 1-3. The f32 parameters' gradients of a weighted sum of
    the logits and the new attention agree within 3% of each leaf's largest
    (read: at most 1.4%, the cell's bias)."""
    B, k, T, U, A = 6, 3, 5, 32, 6
    r = np.random.RandomState(seed)
    c, h, att = (0.5 * r.randn(B, U).astype(np.float32) for _ in range(3))
    align = r.uniform(0, 1, (B, k, T)).astype(np.float32)
    align /= align.sum(-1, keepdims=True)
    memory, keys = (0.5 * r.randn(B, k, T, U).astype(np.float32)
                    for _ in range(2))
    mask = np.arange(T)[None, None] < r.randint(2, T + 1, (B, k))[..., None]
    ids = r.randint(0, A + 2, B)  # id A + 1 embeds to zeros
    w_logits = r.randn(B, A).astype(np.float32)
    w_att = r.randn(B, U).astype(np.float32)
    carry = ((c, h), att, align)

    core_j = _AttnDecoderCore(A, U, "pallas", attn_type)
    shapes = jax.eval_shape(lambda: core_j.init(
        jax.random.key(0), carry, np.zeros((B, U), np.float32), memory, keys,
        mask))["params"]
    params = jax.tree.map(
        lambda leaf: (0.2 * r.randn(*leaf.shape)).astype(np.float32), shapes)

    def step_j(p):
        v = {"params": _bf16_tree(p)}
        return core_j.apply(v, _bf16_tree(carry),
                            core_j.apply(v, ids, method=core_j.embed),
                            _bf16_tree(memory), _bf16_tree(keys), mask)

    def weighted(out):
        (_, attention, _), logits = out
        return ((logits.astype(jnp.float32) * w_logits).sum()
                + (attention.astype(jnp.float32) * w_att).sum())

    ((c_j, h_j), att_j, align_j), logits_j = step_j(params)
    g_j = flax_to_state_dict(jax.grad(lambda p: weighted(step_j(p)))(params))

    core_t = AttnDecoderCore(A, U, U, "pallas", attn_type)
    core_t.load_state_dict(flax_to_state_dict(params))
    p_t = cast_floats(dict(core_t.named_parameters()), BF16_T)

    def bf16(a):
        return torch.from_numpy(a).to(BF16_T)

    ((c_t, h_t), att_t, align_t), logits_t = functional_call(
        core_t, p_t, (((bf16(c), bf16(h)), bf16(att), bf16(align)),
                      embed(p_t["embedding"], torch.from_numpy(ids)),
                      bf16(memory), bf16(keys), torch.from_numpy(mask)))
    for got, want, floor, bound in (
            (c_t, c_j, 0.25, 0), (h_t, h_j, 0.25, 0), (att_t, att_j, 0.25, 2),
            (align_t, align_j, 2.0 ** -4, 3), (logits_t, logits_j, 0.25, 2)):
        assert got.dtype == BF16_T and want.dtype == jnp.bfloat16
        assert _ulps(_np(got), want, floor=floor) <= bound
    ((logits_t.float() * torch.from_numpy(w_logits)).sum()
     + (att_t.float() * torch.from_numpy(w_att)).sum()).backward()
    for name, p in core_t.named_parameters():
        assert p.grad.dtype == g_j[name].dtype == torch.float32
        err = (p.grad - g_j[name]).abs().max().item()
        assert err <= 0.03 * g_j[name].abs().max().item(), (name, err)


def _jax_induction_default_bf16():
    cfg = dataclasses.replace(_tiny_cfg(), model="induction_baseline",
                              cell_impl="pallas_jnp")
    batch = family_batch(cfg)
    jmodel = jax_model_class("induction_baseline")(cfg, train=False)
    variables = _random_variables(jmodel, batch, seed=2)
    jax.eval_shape(lambda v, b: jmodel.apply(_bf16_tree(v), _bf16_tree(b)),
                   variables, batch)


# -- (d) the eval step -----------------------------------------------------------

# The tiny model's bf16 program logits lie below 0.5, where one bf16 ulp is
# 2e-3: a greedy choice is comparable when the JAX top-2 gap is at least
# four of those. Readings at seed 2: the rows' smallest gaps are 0.0146 to
# 0.0215, and all four rows decode the same ids on both sides.
TIE_GAP = 4 * 2.0 ** -9


@pytest.mark.parametrize("domain", ["karel"])
def test_eval_step_matches_jax(split, domain):
    """The bf16 eval step (greedy) from converted random variables: report
    scalars within 2e-2 (losses) and one token of the batch (accuracies) of
    the JAX bf16 step's; greedy program ids and lengths exact on the rows
    whose every JAX top-2 logit gap is at least TIE_GAP (seed 2: all of
    them; at least half are required); everything that leaves the step is f32 or int."""
    args = trainer_cli.parse_args([
        "--device", "cpu", "--num_k", str(SPLIT.k), "--batch_size", str(BS),
        "--num_lstm_cell_units", "64", "--cell_impl", "pallas",
        "--compute_dtype", "bfloat16"])
    cfg = config_from_dataset(args, split)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jmodel = JaxFullModel(jcfg, train=False)
    batch = {k: v for k, v in split.get_batch_compact(
        split.ids[:BS]).items() if k != "id"}
    variables = _random_variables(jmodel, jax_expand(batch, jcfg), seed=2)
    state = JaxTrainState(step=np.zeros((), np.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=None)
    rep_j, ev_j = jax.device_get(jax_eval_step(jmodel, jcfg, "full")(
        state, batch))
    model = get_model_class("full")(cfg)
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    rep_t, ev_t = make_eval_step(model, cfg, "full", image_tensors=True)(
        to_device(batch, "cpu"))
    assert set(rep_t) == set(rep_j)
    for k in rep_j:
        assert rep_t[k].dtype == torch.float32
        tol = 0.1 if k.endswith("acc") else 2e-2
        assert abs(float(rep_t[k]) - float(rep_j[k])) <= tol, k
    assert set(ev_j) == set(ev_t)
    for k, v in ev_t.items():
        assert v.dtype in (torch.float32, torch.int32), (k, v.dtype)
        if k in ("pred_per", "pred_action_probs"):
            # JAX keeps the bf16 logits' dtype; the port hands out f32 (so
            # the trainer's image summaries reach numpy); probabilities of
            # two bf16 forwards, within the reports' 2e-2
            assert str(ev_j[k].dtype) == "bfloat16", k
            want = np.asarray(ev_j[k], np.float32)
            np.testing.assert_allclose(v.numpy(), want, rtol=0, atol=2e-2,
                                       err_msg=k)
            continue
        assert str(v.dtype).replace("torch.", "") == str(ev_j[k].dtype), k

    # the JAX greedy logits, to find the rows outside ties
    out_j = jmodel.apply(_bf16_tree({"params": variables["params"],
                                     "batch_stats": variables["batch_stats"]}),
                         _bf16_tree(jax_expand(batch, jcfg)))
    top2 = np.sort(np.asarray(out_j["greedy_program_logits"], np.float32),
                   axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]).min(axis=-1) >= TIE_GAP
    assert clear.sum() >= BS // 2, clear
    for k in ("greedy_tokens", "greedy_len"):
        np.testing.assert_array_equal(ev_t[k].numpy()[clear],
                                      np.asarray(ev_j[k])[clear], err_msg=k)


# -- trainer, checkpoints, evaler ----------------------------------------------------

BF16 = ("--compute_dtype", "bfloat16")  # the CLI flags


def _train(split_, train_dir, max_steps, *extra):
    trainer = Trainer(trainer_args(train_dir, *extra), split_, split_, device="cpu")
    trainer.train(max_steps=max_steps)
    return trainer


@pytest.fixture(scope="module")
def bf16_trained(split, tmp_path_factory):
    """4 uninterrupted bf16 steps (checkpoints at 2 and 4)."""
    return _train(split, tmp_path_factory.mktemp("bf16_run"), 4, *BF16)


def test_bf16_checkpoint_has_the_f32_layout(split, bf16_trained, tmp_path):
    """A bf16 run saves what an f32 run saves: the same keys, shapes and
    dtypes (f32 parameters, statistics and Adam moments), other values."""
    f32 = _train(split, tmp_path, 2)
    a = checkpoint.load(checkpoint.checkpoint_path(bf16_trained.train_dir, 2))
    b = checkpoint.load(checkpoint.checkpoint_path(f32.train_dir, 2))
    assert a["step"] == b["step"] == 2 and set(a["model"]) == set(b["model"])
    for k, v in b["model"].items():
        assert (a["model"][k].dtype, a["model"][k].shape) == (v.dtype,
                                                               v.shape), k
    assert any(not torch.equal(a["model"][k], v)
               for k, v in b["model"].items())
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert set(sa) == set(sb)
    for i in sb:
        for k, v in sb[i].items():
            assert torch.as_tensor(sa[i][k]).dtype == torch.as_tensor(
                v).dtype, (i, k)


def test_bf16_exact_resume_is_bitwise(split, bf16_trained, tmp_path):
    """2 bf16 steps and an auto-resume to 4 == 4 uninterrupted bf16 steps,
    bitwise on parameters, BN statistics and Adam's state."""
    first = _train(split, tmp_path, 2, *BF16)
    with open(os.path.join(first.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": 4}, f)
    resumed = Trainer(trainer_args(tmp_path, *BF16), split, split, device="cpu")
    assert resumed._auto_resumed and resumed.state.step == 2
    resumed.train(max_steps=4)
    want = bf16_trained.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    opt_want = bf16_trained.state.optimizer.state_dict()["state"]
    opt_got = resumed.state.optimizer.state_dict()["state"]
    for i in opt_want:
        for k in opt_want[i]:
            assert torch.equal(opt_got[i][k], opt_want[i][k]), (i, k)


@pytest.mark.parametrize("trained_in,evaluated_in", [
    ("bfloat16", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16")])
def test_checkpoints_cross_compute_dtypes(split, bf16_trained, tmp_path,
                                          trained_in, evaluated_in):
    """A checkpoint of either compute dtype evaluates in either: the Evaler
    loads the same f32 weights, and the two reports lie within 5e-2."""
    run = bf16_trained if trained_in == "bfloat16" else _train(
        split, tmp_path, 2)
    losses = {}
    for dtype in {evaluated_in, "float32"}:
        args = evaler_cli.parse_args([
            "--dataset_path", "in-memory", "--num_k", str(SPLIT.k),
            "--batch_size", str(BS), "--num_lstm_cell_units", "32",
            "--cell_impl", "pallas", "--max_steps", "1", "--quiet",
            "--no_write_summary", "--device", "cpu", "--train_dir",
            run.train_dir, "--compute_dtype", dtype])
        evaler = Evaler(args, split, device="cpu")
        for k, v in run.model.state_dict().items():
            assert torch.equal(evaler.model.state_dict()[k], v), k
        losses[dtype] = evaler.eval_run()[0]["loss"]
    assert np.isfinite(list(losses.values())).all()
    assert abs(losses[evaluated_in] - losses["float32"]) <= 5e-2, losses


@pytest.mark.parametrize("mode", ["greedy", "beam", "syntax_greedy",
                                  "syntax_sample"])
def test_every_unroll_type_evaluates_in_bf16(split, bf16_trained, mode):
    """Each decode mode through the Evaler in bf16: a finite report, and
    constrained programs that parse."""
    args = evaler_cli.parse_args([
        "--dataset_path", "in-memory", "--num_k", str(SPLIT.k),
        "--batch_size", str(BS), "--num_lstm_cell_units", "32",
        "--cell_impl", "pallas", "--max_steps", "1", "--quiet",
        "--no_write_summary", "--device", "cpu", "--train_dir",
        bf16_trained.train_dir, "--unroll_type", mode, "--beam_width", "3",
        "--execution_rerank", *BF16])
    loss, acc, hist = Evaler(args, split, device="cpu").eval_run()
    assert all(np.isfinite(v).all() for d in (loss, acc, hist)
               for v in d.values())
    if mode.startswith("syntax"):
        assert acc["greedy_program_syntax_acc"] == 1.0


def test_scheduled_sampling_trains_in_bf16(split, tmp_path):
    trainer = _train(split, tmp_path, 2, "--scheduled_sampling",
                     "--scheduled_sampling_decay_steps", "2", *BF16)
    assert trainer.state.step == 2
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


# -- the config ------------------------------------------------------------------

def test_compute_dtype_values():
    for dtype in ("float32", "bfloat16"):
        check_ported(ModelConfig(compute_dtype=dtype))
    with pytest.raises(ValueError, match="compute_dtype"):
        check_ported(ModelConfig(compute_dtype="float16"))
