"""The port's ViZDoom device side vs the JAX package, on the CPU, tiny
config (units 32, k 3, 80x80x3 DoomLite frames): the device cache and
`expand_doom_batch`, the 5-conv state encoder, each model family's forward,
and the full model's train step (three steps on random pixels, one on the
DoomLite frames themselves).

Batches come from a DoomLite split of the port's generator (bit for bit the
JAX generator's, tests/test_torch_vizdoom_dsl.py). Model variables are
drawn with numpy as tests/test_torch_models.py draws them, but conv1's
kernel is scaled by 1/255: frames arrive as raw 0-255 pixels, and the
eval-mode BatchNorms run on random statistics, which would otherwise let
the activations grow by two orders of magnitude a layer.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from demo2program_tpu.data.vizdoom_dataset import (
    create_vizdoom_splits as jax_splits)
from demo2program_tpu.data.vizdoom_generator import (
    VizdoomGeneratorConfig as JaxGeneratorConfig, generate as jax_generate)
from demo2program_tpu.models.common import ModelConfig as JaxConfig
from demo2program_tpu.models.encoder import StateEncoder as JaxStateEncoder
from demo2program_tpu.models.registry import (
    get_model_class as jax_model_class)
from demo2program_tpu.ops.reconstruct import expand_batch as jax_expand
from demo2program_tpu.train.device_cache import (
    DoomDeviceCache as JaxDoomCache)
from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.models.encoder import StateEncoder
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.train.device_cache import DoomDeviceCache
from tests.test_torch_models import (
    _random_variables, _tensors, assert_outputs_match, count_lstm_steps)
from tests.test_torch_train import (
    LR, N_STEPS, PER_EMBED_BIAS, check_params_and_bn_statistics,
    check_reports_and_gradients, run_train_parity)

BS, K = 4, 3
GEN = dict(num_train=12, num_test=4, num_val=0, seed=7,
           num_demo_per_program=4, num_test_demo_per_program=2)
FAMILIES = ("full", "synthesis_baseline", "summarizer", "induction_baseline")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A tiny ViZDoom HDF5 dataset -> (path, the port's train split)."""
    path = str(tmp_path_factory.mktemp("vizdoom") / "d")
    jax_generate(JaxGeneratorConfig(dir_name=path, **GEN))
    return path, create_vizdoom_splits(path, num_k=K)[0]


def _args(model_name="full", *extra):
    return trainer_cli.parse_args([
        "--device", "cpu", "--model", model_name, "--dataset_type", "vizdoom",
        "--num_k", str(K), "--batch_size", str(BS),
        "--num_lstm_cell_units", "32", *extra])


def _batch(split, start=0):
    """The full-wire numpy batch of BS items, ids dropped."""
    batch = split.get_batch(split.ids[start:start + BS])
    batch.pop("id")
    return batch


def _variables(jax_model, batch, seed):
    def scale(path, leaf):
        name = jax.tree_util.keystr(path)
        return leaf / 255.0 if "conv1" in name and "kernel" in name else leaf
    variables = _random_variables(jax_model, batch, seed)
    return jax.tree_util.tree_map_with_path(scale, variables)


def test_cache_follows_the_jax_stream(dataset):
    """The port's DoomDeviceCache draws the JAX cache's index stream (ids
    of batch s equal) and serves its arrays; it reads the sidecar the JAX
    cache wrote."""
    path, _ = dataset
    ds_j = jax_splits(path, num_k=K)[0]
    cache_j = JaxDoomCache(ds_j, BS, seed=3)
    ds_t = create_vizdoom_splits(path, num_k=K)[0]
    cache_t = DoomDeviceCache(ds_t, "cpu", BS, seed=3)
    for step in range(7):  # over two epochs
        want = next(cache_j)
        idx = cache_t.indices(step)
        assert list(ds_t.ids[i] for i in idx) == list(want["id"])
        got = cache_t.batch(step)
        assert set(got) == set(want) - {"id"}
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]),
                                          err_msg=k)


def test_cache_fast_forward_and_batch_size(dataset):
    """batch(s) is the stream's s-th draw however it is reached: in order,
    after a fast_forward, or asked again from a new cache (a resumed run);
    set_batch_size restarts the stream at the new size."""
    _, split = dataset
    a = DoomDeviceCache(split, "cpu", BS, seed=5)
    seq = [a.indices(s).tolist() for s in range(8)]
    b = DoomDeviceCache(split, "cpu", BS, seed=5)
    b.fast_forward(5)
    assert [b.indices(s).tolist() for s in range(5, 8)] == seq[5:]
    c = DoomDeviceCache(split, "cpu", BS, seed=5)
    assert c.indices(6).tolist() == seq[6]
    assert c.indices(2).tolist() == seq[2]  # back in the stream: replayed
    a.set_batch_size(2)
    small = DoomDeviceCache(split, "cpu", 2, seed=5)
    assert [a.indices(s).tolist() for s in range(4)] == [
        small.indices(s).tolist() for s in range(4)]
    with pytest.raises(ValueError, match="exceeds split size"):
        a.set_batch_size(len(split.ids) + 1)


def test_expand_doom_batch_matches_jax(dataset):
    """A cached batch expanded by the port == by JAX, and == the reader's
    full-wire batch of the same ids (program one-hot, frames, percepts,
    the action supervision with its quirks)."""
    _, split = dataset
    cache = DoomDeviceCache(split, "cpu", BS, seed=1,
                            include_test_actions=True)
    cfg = config_from_dataset(_args(), split)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    for step in (0, 1):
        raw = cache.batch(step)
        got = expand_batch(raw, cfg)
        want = jax_expand({k: v.numpy() for k, v in raw.items()}, jcfg)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        wire = split.get_batch([split.ids[i] for i in cache.indices(step)])
        for k in ("program", "program_tokens", "s_h", "per", "a_h",
                  "a_h_tokens", "test_a_h", "test_a_h_tokens", "demo_len",
                  "test_demo_len", "program_len"):
            np.testing.assert_array_equal(got[k].numpy(), wire[k], err_msg=k)


def test_state_encoder_5conv_matches_jax(dataset):
    """The ViZDoom state encoder (5 convs, flax SAME padding 80 -> 40 ->
    20 -> 10 -> 5 -> 3, 432 features) with running statistics, atol 1e-5.
    The train-mode encoder, BatchNorm on batch statistics, is held on the
    same frames inside the full model's train step
    (test_real_frame_*)."""
    _, split = dataset
    frames = _batch(split)["s_h"].reshape((-1, 80, 80, 3))[:24]
    enc_j = JaxStateEncoder(train=False, dataset_type="vizdoom")
    variables = _variables(enc_j, frames, seed=3)
    out_j = enc_j.apply(variables, frames)
    enc_t = StateEncoder(80, 80, 3, "vizdoom")
    enc_t.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    assert enc_t.out_features == 432 == np.asarray(out_j).shape[1]
    with torch.no_grad():
        out_t = enc_t.eval()(torch.from_numpy(frames))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)


# seeds of the variables at which no greedy argmax of the family lies
# within 1e-4 of a tie (the comparison would skip)
FAMILY_SEEDS = {"full": 2, "synthesis_baseline": 2, "summarizer": 2,
                "induction_baseline": 2}


@pytest.mark.parametrize("model_name", FAMILIES)
def test_family_forward_matches_jax(dataset, model_name, monkeypatch):
    """Each family's eval forward on a ViZDoom batch: logits atol 1e-4,
    greedy tokens exact (argmax-tie guard); and its LSTM steps."""
    _, split = dataset
    cfg = config_from_dataset(_args(model_name), split)
    batch = _batch(split)
    jax_model = jax_model_class(model_name)(
        JaxConfig(**dataclasses.asdict(cfg)), train=False)
    variables = _variables(jax_model, batch, FAMILY_SEEDS[model_name])
    model = get_model_class(model_name)(cfg)
    model.load_state_dict(flax_to_state_dict(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    out_j = jax.device_get(jax.jit(jax_model.apply)(variables, batch))
    with torch.no_grad():
        out_t = model.eval()(_tensors(batch))
    assert_outputs_match(out_t, out_j)
    T, L = cfg.max_demo_len, cfg.max_program_len
    per_eval = {"full": 5 * T + 2 * L, "synthesis_baseline": T + 2 * L,
                "summarizer": 2 * T + 2 * L,
                "induction_baseline": T + 2 * T}[model_name]
    assert count_lstm_steps(monkeypatch, model, batch, True) == per_eval


def test_syntax_modes_raise_on_vizdoom(dataset):
    _, split = dataset
    model = get_model_class("full")(config_from_dataset(_args(), split))
    with pytest.raises(NotImplementedError, match="karel DSL"):
        with torch.no_grad():
            model.eval()(_tensors(_batch(split)),
                         decode_mode="syntax_greedy")


def _cache_batches(split, random_pixels):
    """The device cache's N_STEPS batches; with `random_pixels` their frames
    replaced by seeded random pixels in 0..3."""
    cache = DoomDeviceCache(split, "cpu", BS, seed=0)
    r = np.random.RandomState(0)
    batches = []
    for s in range(N_STEPS):
        batch = {k: v.numpy() for k, v in cache.batch(s).items()}
        if random_pixels:
            batch["dc_s_h"] = r.randint(0, 4, batch["dc_s_h"].shape).astype(
                np.uint8)
        batches.append(batch)
    return batches


# on DoomLite's own frames, one step: the JAX gradient's share of its
# leaf's largest within which the two sides may round to opposite signs
REAL_GRAD_RTOL = 1e-3


def print_readings(runs, label):
    """Print how far apart the two sides are after each step (shown with
    pytest -s): the grad norms' relative difference; at step 1 the worst
    gradient over its leaf's largest; the worst parameter difference on the
    elements whose gradient stayed above REAL_GRAD_RTOL of its leaf's
    largest in every step so far, and on the others; the worst BN running
    statistic over its leaf's largest magnitude."""
    grads = runs["grads_j"]
    near_zero = {}
    for i, s in enumerate(runs["steps"]):
        norm = abs(float(s["rep_t"]["grad_norm"])
                   / float(s["rep_j"]["grad_norm"]) - 1)
        line = f"{label} step {i + 1}: grad norms {norm:.2g} apart"
        if i == 0:
            share, name = max(
                ((g - grads[n]).abs().max().item()
                 / grads[n].abs().max().item(), n)
                for n, g in s["grads_t"].items() if n != PER_EMBED_BIAS)
            line += f", gradients {share:.2g} of the leaf's largest ({name})"
        far, near = (0.0, ""), 0.0
        for n in runs["params"]:
            g = (grads[n] if i == 0 else s["grads_t"][n]).abs().numpy()
            near_zero[n] = near_zero.get(n, False) | (
                g <= REAL_GRAD_RTOL * g.max() + 1e-7)
            err = (s["sd_t"][n] - s["sd_j"][n]).abs().numpy()
            if n != PER_EMBED_BIAS:
                far = max(far, (float(err[~near_zero[n]].max(initial=0.0)), n))
            near = max(near, float(err[near_zero[n]].max(initial=0.0)))
        stats = max(((s["sd_t"][n] - s["sd_j"][n]).abs().max().item()
                     / s["sd_j"][n].abs().max().item(), n)
                    for n in s["sd_j"] if "running_" in n)
        print(f"{line}; parameters {far[0]:.2g} ({far[1]}), {near:.2g} where "
              f"a gradient came near zero; BN statistics {stats[0]:.2g} of "
              f"the leaf's largest ({stats[1]})")


@pytest.fixture(scope="module")
def train_runs(dataset):
    """N_STEPS steps of the full model, JAX `make_step_fn` (pallas in
    interpret mode) vs the port, on the device cache's batches with their
    frames replaced by seeded random pixels in 0..3, so that the checks of
    tests/test_torch_train.py hold over all three steps. (On DoomLite's own
    0..255 frames step 1's gradients differ by up to 3.1e-4 of a leaf's
    largest, conv2's bias, past those checks' 1e-4, and the second step's
    grad norms by 3.9e-3: the real frames are held to step 1 with per-leaf
    bounds below.)"""
    _, split = dataset
    runs = run_train_parity(split, "full", "pallas",
                            batches=_cache_batches(split, True),
                            extra_flags=("--dataset_type", "vizdoom"))
    print_readings(runs, "random pixels")
    return runs


def test_train_step_reports_and_gradients_match_jax(train_runs):
    check_reports_and_gradients(train_runs)


def test_params_and_bn_statistics_match_jax(train_runs):
    """After one step. (After three, the parameters differ by up to 5.3e-5,
    conv2's kernel, on elements whose gradient stayed above 1e-3 of its
    leaf's largest in every step: Adam's normalised steps carry the f32
    rounding of small gradients past the 1e-5 bound, not a fault.)"""
    check_params_and_bn_statistics(train_runs, 1)


@pytest.fixture(scope="module")
def real_frame_runs(dataset):
    """The same steps on the device cache's own batches: DoomLite's 0..255
    frames through the train-mode 5-conv encoder and its BatchNorms."""
    _, split = dataset
    runs = run_train_parity(split, "full", "pallas",
                            batches=_cache_batches(split, False),
                            extra_flags=("--dataset_type", "vizdoom"))
    print_readings(runs, "DoomLite frames")
    return runs


def test_real_frame_step_reports_and_gradients_match_jax(real_frame_runs):
    """Step 1: every report scalar at atol 1e-4 (grad_norm rtol 1e-4), and
    each leaf's gradient within 1e-3 of its largest (chip_smoke.py's
    card-vs-CPU bound; the worst leaf reads 3.1e-4). Later steps are not
    held: step 1's parameters already differ where gradients round to
    opposite signs (next test), and step 2's grad norms read 3.9e-3
    apart."""
    first = dict(real_frame_runs, steps=real_frame_runs["steps"][:1])
    check_reports_and_gradients(first, grad_rtol=REAL_GRAD_RTOL)


def test_real_frame_params_and_bn_statistics_match_jax(real_frame_runs):
    """After step 1, each leaf against its own scale. Adam's first step
    moves an element by lr * g / (|g| + eps), about lr * sign(g): where the
    JAX gradient lies within the gradient bound of zero the two sides may
    step opposite ways, up to 2 * lr apart (the worst reads 1.9e-3, about
    9% of the elements are such); every other element within 1e-5 (reads
    1.4e-7). BN running statistics within 1e-4 of each leaf's largest
    magnitude (reads 1.4e-5: conv1's running_var, at 544, by 7.5e-3)."""
    runs = real_frame_runs
    sd_t, sd_j = runs["steps"][0]["sd_t"], runs["steps"][0]["sd_j"]
    for name in runs["params"]:
        g = runs["grads_j"][name].abs().numpy()
        near_zero = g <= REAL_GRAD_RTOL * g.max() + 1e-7
        err = (sd_t[name] - sd_j[name]).abs().numpy()
        assert err[~near_zero].max(initial=0.0) <= 1e-5, (
            name, err[~near_zero].max())
        assert err[near_zero].max(initial=0.0) <= 2 * LR, name
    for name in sd_j:
        if "running_" in name:
            err = (sd_t[name] - sd_j[name]).abs().max().item()
            scale = sd_j[name].abs().max().item()
            assert err <= 1e-4 * scale, (name, err, scale)
