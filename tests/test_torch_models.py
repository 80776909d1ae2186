"""Model stack of the PyTorch port vs the JAX modules, tiny config.

The flax variable tree's shapes come from `jax.eval_shape`; every leaf is
then drawn with numpy (kernels ~ N(0, 1/fan_in), BN running mean random and
running var positive, so a wrong batch norm shows), converted with
demo2program_tpu_torch.models.convert and loaded into the port's modules.
Both sides get the same numpy batch.

Float outputs agree to atol 1e-4: f32 sums run in other orders through up
to T + L recurrent steps. Greedy token ids and lengths must be exact; a
case whose JAX top-2 logit gap falls below 1e-4 would be an argmax tie, so
the test says so and skips instead of comparing it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _random_batch, _tiny_cfg
from demo2program_tpu.models.common import (
    TwoPassDemoEncoder as JaxEncoder)
from demo2program_tpu.models.decoder import (
    TokenDecoder as JaxTokenDecoder, VectorDecoder as JaxVectorDecoder)
from demo2program_tpu.models.full import FullModel as JaxFullModel
from demo2program_tpu.models.registry import (
    get_model_class as jax_model_class)
from demo2program_tpu_torch.models.common import ModelConfig
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.models.full import FullModel
from demo2program_tpu_torch.models.ops import same_padding
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops import fused_lstm

ATOL = 1e-4
GAP = 1e-4
BS = 3


def _cfg(cell_impl):
    return dataclasses.replace(_tiny_cfg(), cell_impl=cell_impl)


def _batch(cfg, seed=0):
    batch = _random_batch(cfg, BS, seed=seed)
    r = np.random.RandomState(seed + 100)
    # ragged demo lengths exercise the masked encoder steps
    batch["demo_len"] = r.randint(2, cfg.max_demo_len + 1,
                                  (BS, cfg.k)).astype(np.float32)
    return batch


def _random_variables(model, batch, seed):
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), batch))
    r = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "'var'" in name:
            return r.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if "'mean'" in name:
            return (0.5 * r.randn(*s.shape)).astype(np.float32)
        if "'scale'" in name:
            return (1 + 0.1 * r.randn(*s.shape)).astype(np.float32)
        if len(s.shape) == 1:
            return (0.1 * r.randn(*s.shape)).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (r.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _torch_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=["pallas_jnp", "xla"])
def pair(request):
    """(cfg, numpy batch, flax variables, JAX outputs, port model)."""
    cfg = _cfg(request.param)
    batch = _batch(cfg)
    jax_model = JaxFullModel(cfg, train=False)
    variables = _random_variables(jax_model, batch, seed=1)
    out = jax.jit(jax_model.apply)(variables, batch)
    model = FullModel(_torch_cfg(cfg))
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    return cfg, batch, variables, jax.device_get(out), model.eval()


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _require_gap(logits, what):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    gap = float((top2[..., 1] - top2[..., 0]).min())
    if gap < GAP:
        pytest.skip(f"{what}: JAX top-2 logit gap {gap:.2e} < {GAP}, an "
                    f"argmax tie; greedy ids are not comparable")


def assert_outputs_match(out_t, out_j, atol=ATOL, program_gap_checked=False):
    """The port's model outputs vs the JAX module's: the same keys, float
    outputs at `atol`, token ids and lengths exact (after the argmax-tie
    guard on every greedy head; `program_gap_checked`: the caller guarded
    the decoded program's choices by its decode mode's own rule)."""
    assert set(out_t) == set(out_j)
    for key in out_j:
        if program_gap_checked and key == "greedy_program_logits":
            continue
        if key.startswith("greedy_") and key.endswith("_logits"):
            _require_gap(out_j[key], key)
    for key in out_j:
        got, want = out_t[key].detach().numpy(), np.asarray(out_j[key])
        assert got.shape == want.shape, key
        if "tokens" in key or key.endswith("_len"):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, atol=atol, rtol=0,
                                       err_msg=key)


def family_batch(cfg, seed=0):
    """`_batch` plus ragged unseen demos with their action rows, which the
    induction baseline decodes."""
    batch = _batch(cfg, seed)
    r = np.random.RandomState(seed + 200)
    tok = r.randint(0, cfg.action_space, (BS, cfg.test_k, cfg.max_demo_len))
    batch["test_a_h"] = np.eye(cfg.action_space, dtype=np.float32)[tok]
    batch["test_a_h_tokens"] = tok.astype(np.int32)
    batch["test_demo_len"] = r.randint(
        2, cfg.max_demo_len + 1, (BS, cfg.test_k)).astype(np.float32)
    return batch


def family_forward_parity(model_name, train, atol=ATOL, **overrides):
    """One forward of `model_name` (tiny config with `overrides`) through
    the JAX module and the port, from random flax variables loaded with
    load_state_dict(strict=True): every output compared; in train mode
    (no greedy decoders, BatchNorm on batch statistics) the updated running
    statistics too, at atol 1e-5. -> the port's model."""
    cfg = dataclasses.replace(_tiny_cfg(), model=model_name, **overrides)
    batch = family_batch(cfg)
    jax_model = jax_model_class(model_name)(cfg, train=train)
    # seed 2: no greedy argmax of any family and variant tested falls
    # within GAP of a tie (seed 1 has three that do)
    variables = _random_variables(jax_model, batch, seed=2)
    stats = variables.get("batch_stats", {})
    model = get_model_class(model_name)(_torch_cfg(cfg))
    model.load_state_dict(flax_to_state_dict(variables["params"], stats),
                          strict=True)
    if not train:
        out_j = jax.jit(jax_model.apply)(variables, batch)
        with torch.no_grad():
            out_t = model.eval()(_tensors(batch))
        assert_outputs_match(out_t, jax.device_get(out_j), atol)
        return model
    out_j, upd = jax.jit(lambda v, b: jax_model.apply(
        v, b, include_greedy=False, mutable=["batch_stats"]))(
            variables, batch)
    with torch.no_grad():
        out_t = model.train()(_tensors(batch), include_greedy=False)
    assert_outputs_match(out_t, jax.device_get(out_j), atol)
    want = flax_to_state_dict(variables["params"],
                              jax.device_get(upd["batch_stats"]))
    got = model.state_dict()
    running = [k for k in want if "running_" in k]
    assert running
    for k in running:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    return model


def count_lstm_steps(monkeypatch, model, batch, include_greedy):
    """LSTM steps one forward of `model` takes (train mode without greedy
    decoders, eval mode with them): every step goes through
    fused_lstm.fused_lstm_step, the call the kernel's launch count sits
    in on the card."""
    calls = []

    def counted(*a):
        calls.append(1)
        return fused_lstm.lstm_step_ref(*a)

    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(fused_lstm, "fused_lstm_step", counted)
        model.train(not include_greedy)
        model(_tensors(batch), include_greedy=include_greedy)
    return len(calls)


def test_same_padding_is_flax_same():
    """flax 'SAME' at stride 2 pads (0, 1) on every Karel layer, which
    torch's padding=1 would not."""
    assert [same_padding(n, 3, 2) for n in (8, 4, 2)] == [(0, 1)] * 3


def test_full_model_matches_jax(pair):
    cfg, batch, _, out_j, model = pair
    with torch.no_grad():
        out_t = model(_tensors(batch))
    assert_outputs_match(out_t, out_j)


def test_encoder_matches_jax(pair):
    cfg, batch, variables, _, model = pair
    enc_j = JaxEncoder(cfg, train=False, rn_aggregation="rn").apply(
        {"params": variables["params"]["encoder"],
         "batch_stats": variables["batch_stats"]["encoder"]},
        batch["s_h"], batch["demo_len"].astype(np.int32))
    with torch.no_grad():
        enc_t = model.encoder(torch.from_numpy(batch["s_h"]),
                              torch.from_numpy(batch["demo_len"]).long())
    for key in enc_j:
        np.testing.assert_allclose(enc_t[key].numpy(), np.asarray(enc_j[key]),
                                   atol=ATOL, rtol=0, err_msg=key)


def test_token_decoder_matches_jax(pair):
    cfg, batch, variables, _, model = pair
    r = np.random.RandomState(5)
    units = cfg.num_lstm_cell_units
    c0, h0 = (r.randn(BS, units).astype(np.float32) for _ in range(2))
    dec_j = JaxTokenDecoder(cfg.dim_program_token, units,
                            cfg.program_end_token, cfg.cell_impl)
    v = {"params": variables["params"]["program_decoder"]}
    tf_j = dec_j.apply(v, c0, h0, batch["program_tokens"],
                       method=JaxTokenDecoder.teacher_forced)
    g_j = dec_j.apply(v, c0, h0, cfg.max_program_len,
                      method=JaxTokenDecoder.greedy)
    dec_t = model.program_decoder
    with torch.no_grad():
        tf_t = dec_t.teacher_forced(
            torch.from_numpy(c0), torch.from_numpy(h0),
            torch.from_numpy(batch["program_tokens"]).long())
        g_t = dec_t.greedy(torch.from_numpy(c0), torch.from_numpy(h0),
                           cfg.max_program_len)
    np.testing.assert_allclose(tf_t.numpy(), np.asarray(tf_j), atol=ATOL,
                               rtol=0)
    _require_gap(g_j[0], "greedy program")
    np.testing.assert_allclose(g_t[0].numpy(), np.asarray(g_j[0]), atol=ATOL,
                               rtol=0)
    for got, want in zip(g_t[1:], g_j[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vector_decoder_matches_jax(pair):
    cfg, batch, variables, _, model = pair
    r = np.random.RandomState(6)
    units = cfg.num_lstm_cell_units
    n = BS * cfg.k
    c0, h0 = (r.randn(n, units).astype(np.float32) for _ in range(2))
    per = batch["per"].reshape(n, cfg.max_demo_len, cfg.per_dim)
    out_j = JaxVectorDecoder(cfg.per_dim, units, False, cfg.cell_impl).apply(
        {"params": variables["params"]["per_decoder"],
         "batch_stats": variables["batch_stats"]["per_decoder"]},
        c0, h0, per)
    with torch.no_grad():
        out_t = model.per_decoder(torch.from_numpy(c0), torch.from_numpy(h0),
                                  torch.from_numpy(per))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
