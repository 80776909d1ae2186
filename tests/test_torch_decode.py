"""The port's decode and scheduled-sampling modes vs the JAX package's, on
the CPU.

The tiny config of __graft_entry__._tiny_cfg (k=3, test_k=2, T=6, L=12,
units=64) and flax variables drawn with numpy (tests/test_torch_models.py),
loaded into the port with models/convert.py. Randomness comes from JAX:
a categorical draw is argmax(logits + Gumbel) and a Bernoulli draw is
uniform < p, so the JAX package's own draws, fed to the port as `noise`,
must give the same tokens.

Token ids and lengths are exact; beam scores and logits agree to atol 1e-5
(f32 sums in other orders). A token choice within GAP of a tie would not be
comparable: each test checks the gaps of the choices it compares and skips
when one is below GAP (none is at these seeds; a skip counts as no pass).

Covered: TokenDecoder.beam (K in 1, 3, 5, and K=1 against greedy),
greedy_constrained (syntax_greedy, its all-masked fallback, syntax_sample),
scheduled (sampling_prob 0, 0.5, 1); the full model's forward in every
decode mode and with scheduled sampling (the synthesis and summarizer files
run the same helpers); the scorer's rerank_pick and the evaler's
_apply_rerank on planted beams; an evaler_cli drive with
--unroll_type beam --execution_rerank.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg
from demo2program_tpu.dsl.karel_syntax import KarelSyntaxOracle, jnp_tables
from demo2program_tpu.eval.evaler import Evaler as JaxEvaler
from demo2program_tpu.eval.scorer import KarelScorer as JaxScorer
from demo2program_tpu.models.decoder import TokenDecoder as JaxTokenDecoder
from demo2program_tpu.models.registry import (
    get_model_class as jax_model_class)
from demo2program_tpu_torch.cli import evaler_cli
from demo2program_tpu_torch.data.karel_memory import generate_split
from demo2program_tpu_torch.dsl.karel_syntax import torch_tables
from demo2program_tpu_torch.eval.evaler import Evaler, config_from_dataset
from demo2program_tpu_torch.eval.scorer import KarelScorer
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.train.step import to_device
from tests.test_torch_models import (
    BS, GAP, _random_variables, _tensors, _torch_cfg, assert_outputs_match,
    family_batch)
from tests.test_torch_trainer import (  # noqa: F401
    SPLIT, drive_clis, log_records)

ATOL = 1e-5          # one decoder from given (c, h)
MODEL_ATOL = 1e-4    # whole models, as tests/test_torch_models.py
DECODE_MODES = ["greedy", "beam", "syntax_greedy", "syntax_sample"]
# the seeds of each family's random variables: no choice of any mode
# tested falls within GAP of a tie (untrained weights give flat
# distributions; about one seed in four of 2-11 has no such choice)
FAMILY_SEEDS = {"full": 3, "synthesis_baseline": 8, "summarizer": 2}


# -- JAX's draws ---------------------------------------------------------------

def syntax_sample_noise(rng, max_len, bs, vocab):
    """The Gumbel draws of greedy_constrained(sample_rng=rng): step t's
    jax.random.categorical draws gumbel(split(rng, L)[t], (bs, V))."""
    keys = jax.random.split(rng, max_len)
    return np.stack([np.asarray(jax.random.gumbel(k, (bs, vocab)))
                     for k in keys])


def scheduled_noise(rng, max_len, bs, vocab):
    """The draws of scheduled(rng): step t's categorical takes the Gumbel
    draws of key [t, 0] and its bernoulli the uniforms of key [t, 1] of
    split(rng, 2L).reshape(L, 2). -> (Gumbel (L, bs, V), uniforms (L, bs))."""
    keys = jax.random.split(rng, 2 * max_len).reshape(max_len, 2)
    g = np.stack([np.asarray(jax.random.gumbel(keys[t, 0], (bs, vocab)))
                  for t in range(max_len)])
    u = np.stack([np.asarray(jax.random.uniform(keys[t, 1], (bs,)))
                  for t in range(max_len)])
    return g, u


def as_torch_noise(noise):
    if isinstance(noise, tuple):
        return tuple(torch.from_numpy(n) for n in noise)
    return torch.from_numpy(noise)


# -- tie guards ------------------------------------------------------------------

def _require(gap, what):
    if gap < GAP:
        pytest.skip(f"{what}: a choice {gap:.2e} from a tie (< {GAP}); the "
                    f"ids are not comparable")


def syntax_masks(tokens, max_len, end_token):
    """The masks (bs, L, V) the constrained decoder applied along the token
    path `tokens` (bs, L): the JAX package's host oracle advanced by each
    legal token, the shortest completion within max_len, end-only once
    finished, nothing left after the program closed."""
    oracle = KarelSyntaxOracle()
    legal, delta = oracle.t["legal"], oracle.t["delta"]
    bs, L = tokens.shape
    masks = np.zeros((bs, L, legal.shape[1]), bool)
    for b in range(bs):
        stack, msum = oracle.run_prefix([])
        finished = False
        for t in range(L):
            tok = int(tokens[b, t])
            if finished:
                masks[b, t, end_token] = True
            elif stack:
                top = stack[-1]
                masks[b, t] = legal[top] & (
                    t + 1 + msum + delta[top] <= max_len)
                if legal[top, tok]:
                    stack, msum = oracle._advance(stack, msum, tok)
            finished |= tok == end_token
    return masks


def require_masked_gaps(scores, masks, what):
    """Top-2 gap of the scores (bs, L, V) among each step's legal tokens."""
    s = np.where(masks, scores, -np.inf)
    n_legal = masks.sum(-1)
    top2 = np.sort(s, axis=-1)[..., -2:]
    gaps = np.where(n_legal >= 2, top2[..., 1] - top2[..., 0], np.inf)
    _require(float(gaps.min()), what)


def require_sample_gaps(logits, gumbels, what):
    """Top-2 gap of logits + Gumbel (bs, L, V), the sampled choices."""
    top2 = np.sort(logits + gumbels, axis=-1)[..., -2:]
    _require(float((top2[..., 1] - top2[..., 0]).min()), what)


class TopKGaps:
    """Wraps torch.topk to record, per call, the smallest gap among the
    top k+1 candidates: the beam's choices and the first one it dropped.
    Beam search calls topk once a step."""

    def __init__(self, monkeypatch):
        self.gaps = []
        original = torch.topk

        def topk(x, k, dim=-1, **kw):
            top = original(x, min(k + 1, x.shape[dim]), dim=dim).values
            self.gaps.append(float((top[..., :-1] - top[..., 1:]).min()))
            return original(x, k, dim=dim, **kw)

        monkeypatch.setattr(torch, "topk", topk)

    def require(self, what):
        _require(min(self.gaps), what)


# -- TokenDecoder ------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    """(cfg, JAX program decoder + its variables, the port's, c0, h0,
    ground-truth tokens) from the full model's random variables."""
    cfg = _tiny_cfg()
    batch = family_batch(cfg)
    jax_model = jax_model_class("full")(cfg, train=False)
    variables = _random_variables(jax_model, batch, seed=2)
    model = get_model_class("full")(_torch_cfg(cfg))
    model.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
    dec_j = JaxTokenDecoder(cfg.dim_program_token, cfg.num_lstm_cell_units,
                            cfg.program_end_token, cfg.cell_impl)
    v = {"params": variables["params"]["program_decoder"]}
    r = np.random.RandomState(11)  # no beam choice within GAP of a tie
    c0, h0 = (r.randn(BS, cfg.num_lstm_cell_units).astype(np.float32)
              for _ in range(2))
    return types.SimpleNamespace(
        cfg=cfg, dec_j=dec_j, v=v, dec_t=model.program_decoder.eval(),
        c0=c0, h0=h0, gt=batch["program_tokens"])


def _jax(d, method, *args, **kw):
    return jax.device_get(d.dec_j.apply(d.v, d.c0, d.h0, *args,
                                        method=method, **kw))


def _port(d, method, *args, **kw):
    with torch.no_grad():
        return getattr(d.dec_t, method)(torch.from_numpy(d.c0),
                                        torch.from_numpy(d.h0), *args, **kw)


def _exact(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_beam_matches_jax(decoders, K, monkeypatch):
    """The best beam's tokens and length and every beam's tokens, lengths
    (exact) and log-prob sums (atol 1e-5), best first; at K=1 the beam
    decodes the greedy program."""
    d = decoders
    L = d.cfg.max_program_len
    gaps = TopKGaps(monkeypatch)
    tok_t, len_t, beams_t = _port(d, "beam", L, K)
    gaps.require(f"beam K={K}")
    tok_j, len_j, beams_j = _jax(d, JaxTokenDecoder.beam, L, K)
    _exact(tok_t, tok_j, "tokens")
    _exact(len_t, len_j, "lengths")
    assert tok_t.dtype == len_t.dtype == torch.int32
    for key in ("tokens", "lengths"):
        _exact(beams_t[key], beams_j[key], key)
    _close(beams_t["scores"], beams_j["scores"], "scores")
    assert (np.diff(beams_t["scores"].numpy(), axis=1) <= 0).all()
    if K == 1:
        # the same program; past its end greedy goes on decoding while a
        # finished beam repeats the end token
        _, g_tok, g_len = _port(d, "greedy", L)
        _exact(len_t, g_len.numpy(), "beam 1 == greedy lengths")
        inside = np.arange(L)[None, :] < len_t.numpy()[:, None]
        np.testing.assert_array_equal(
            np.where(inside, tok_t.numpy(), -1),
            np.where(inside, g_tok.numpy(), -1), "beam 1 == greedy tokens")


def test_syntax_greedy_matches_jax(decoders):
    """Masked argmax: tokens and lengths exact, logits at atol 1e-5; every
    program the decoder finished parses."""
    d = decoders
    L, end = d.cfg.max_program_len, d.cfg.program_end_token
    logits_j, tok_j, len_j = _jax(d, JaxTokenDecoder.greedy_constrained, L,
                                  jnp_tables())
    require_masked_gaps(logits_j, syntax_masks(tok_j, L, end),
                        "syntax_greedy")
    logits_t, tok_t, len_t = _port(d, "greedy_constrained", L,
                                   torch_tables("cpu"))
    _exact(tok_t, tok_j, "tokens")
    _exact(len_t, len_j, "lengths")
    _close(logits_t, logits_j, "logits")


def test_syntax_fallback_when_nothing_fits(decoders):
    """At max_len 3 no program fits (the shortest takes 5 tokens): every
    candidate is masked out at every step and token 0 is emitted, as in
    the JAX decoder."""
    d = decoders
    _, tok_j, len_j = _jax(d, JaxTokenDecoder.greedy_constrained, 3,
                           jnp_tables())
    _, tok_t, len_t = _port(d, "greedy_constrained", 3, torch_tables("cpu"))
    assert not tok_t.any()
    _exact(tok_t, tok_j, "tokens")
    _exact(len_t, len_j, "lengths")


def test_syntax_sample_matches_jax(decoders):
    """Masked sampling on JAX's own draws: tokens and lengths exact."""
    d = decoders
    L, V, end = (d.cfg.max_program_len, d.cfg.dim_program_token,
                 d.cfg.program_end_token)
    rng = jax.random.key(7)
    logits_j, tok_j, len_j = _jax(d, JaxTokenDecoder.greedy_constrained, L,
                                  jnp_tables(), sample_rng=rng)
    noise = syntax_sample_noise(rng, L, BS, V)
    require_masked_gaps(logits_j + noise.transpose(1, 0, 2),
                        syntax_masks(tok_j, L, end), "syntax_sample")
    logits_t, tok_t, len_t = _port(d, "greedy_constrained", L,
                                   torch_tables("cpu"), sample=True,
                                   noise=torch.from_numpy(noise))
    _exact(tok_t, tok_j, "tokens")
    _exact(len_t, len_j, "lengths")
    _close(logits_t, logits_j, "logits")


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_scheduled_matches_jax(decoders, p):
    """Scheduled sampling at sampling_prob p on JAX's draws: the sampled
    ids exact, the logits at atol 1e-5. p=0 is teacher forcing; at p=1
    every step after the first feeds back the previous sample."""
    d = decoders
    L, V = d.cfg.max_program_len, d.cfg.dim_program_token
    rng = jax.random.key(11)
    logits_j, ids_j = _jax(d, JaxTokenDecoder.scheduled, d.gt, p, rng,
                           return_sampled=True)
    g, u = scheduled_noise(rng, L, BS, V)
    require_sample_gaps(logits_j, g.transpose(1, 0, 2), "scheduled")
    logits_t, ids_t = _port(d, "scheduled", torch.from_numpy(d.gt).long(),
                            p, noise=as_torch_noise((g, u)))
    _exact(ids_t, ids_j, "sampled ids")
    _close(logits_t, logits_j, "logits")
    if p == 0.0:
        _close(logits_t, _port(d, "teacher_forced",
                               torch.from_numpy(d.gt).long()).numpy(),
               "p=0 is teacher forcing", atol=0)


# -- through the model families -----------------------------------------------

def _family(model_name, **overrides):
    cfg = dataclasses.replace(_tiny_cfg(), model=model_name, **overrides)
    batch = family_batch(cfg)
    variables = _random_variables(
        jax_model_class(model_name)(cfg, train=False), batch,
        seed=FAMILY_SEEDS[model_name])
    model = get_model_class(model_name)(_torch_cfg(cfg))
    model.load_state_dict(flax_to_state_dict(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return cfg, batch, variables, model


def decode_forward_parity(model_name, mode, monkeypatch, **overrides):
    """An eval forward of `model_name` in decode mode `mode` through the
    JAX module and the port (syntax_sample on JAX's draws): every output
    compared as in test_torch_models.assert_outputs_match, the decoded
    program's choices guarded by the gaps of its own mode."""
    cfg, batch, variables, model = _family(model_name, **overrides)
    L, V, end = (cfg.max_program_len, cfg.dim_program_token,
                 cfg.program_end_token)
    rng = jax.random.key(7)
    out_j = jax.device_get(jax.jit(lambda v, b: jax_model_class(model_name)(
        cfg, train=False).apply(v, b, decode_mode=mode, rng=rng))(
            variables, batch))
    noise = (syntax_sample_noise(rng, L, BS, V) if mode == "syntax_sample"
             else None)
    gaps = TopKGaps(monkeypatch) if mode == "beam" else None
    with torch.no_grad():
        out_t = model.eval()(
            _tensors(batch), decode_mode=mode,
            decode_noise=None if noise is None else torch.from_numpy(noise))
    key = "greedy_program_logits"
    if mode == "beam":
        gaps.require(f"{model_name} beam")
    elif mode.startswith("syntax"):
        scores = out_j[key] + (0 if noise is None else
                               noise.transpose(1, 0, 2))
        require_masked_gaps(scores, syntax_masks(
            out_j["greedy_program_tokens"], L, end), f"{model_name} {mode}")
    assert_outputs_match(out_t, out_j, MODEL_ATOL,
                         program_gap_checked=mode != "greedy")
    return out_t


def scheduled_forward_parity(model_name, p, **overrides):
    """A train-mode forward of `model_name` with scheduled sampling at
    sampling_prob p on JAX's draws: the program logits, the sampled ids
    (`pred_program_tokens`, exact) and every other output, as in
    test_torch_models.family_forward_parity."""
    cfg, batch, variables, model = _family(model_name, **overrides)
    L, V = cfg.max_program_len, cfg.dim_program_token
    rng = jax.random.key(13)
    out_j, _ = jax.device_get(jax.jit(lambda v, b: jax_model_class(
        model_name)(cfg, train=True).apply(
            v, b, include_greedy=False, sampling_prob=p, rng=rng,
            mutable=["batch_stats"]))(variables, batch))
    g, u = scheduled_noise(rng, L, BS, V)
    require_sample_gaps(out_j["pred_program_logits"], g.transpose(1, 0, 2),
                        f"{model_name} scheduled")
    with torch.no_grad():
        out_t = model.train()(_tensors(batch), include_greedy=False,
                              sampling_prob=p, noise=as_torch_noise((g, u)))
    assert "pred_program_tokens" in out_t
    assert_outputs_match(out_t, out_j, MODEL_ATOL)
    return out_t


@pytest.mark.parametrize("mode", DECODE_MODES)
def test_full_model_decode_modes_match_jax(mode, monkeypatch):
    out = decode_forward_parity("full", mode, monkeypatch)
    if mode == "beam":
        assert out["beam_tokens"].shape == (BS, 5, _tiny_cfg().max_program_len)


@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_full_model_scheduled_sampling_matches_jax(p):
    scheduled_forward_parity("full", p)


# -- execution rerank ------------------------------------------------------------

@pytest.fixture(scope="module")
def planted():
    """A compact batch of the in-memory split and K=4 beams per example,
    the ground-truth program planted as beam 2 (after sorting by score) in
    the even rows; beam 0 is the ground truth's first 4 tokens, beam 1 a
    program of another row, beam 3 garbage. The scores are shuffled."""
    split = generate_split(SPLIT)
    args = evaler_cli.parse_args([
        "--dataset_path", "in-memory", "--num_k", str(SPLIT.k),
        "--batch_size", "4", "--num_lstm_cell_units", "16",
        "--device", "cpu"])
    cfg = config_from_dataset(args, split)
    batch = split.get_batch_compact(split.ids[:4])
    gt, gl = batch["program_tokens"], batch["program_len"][:, 0].astype(int)
    bs, L = gt.shape
    r = np.random.RandomState(3)
    tokens = np.zeros((bs, 4, L), np.int32)
    lengths = np.zeros((bs, 4), np.int32)
    for i in range(bs):
        tokens[i, 0, :4], lengths[i, 0] = gt[i, :4], 4
        j = (i + 1) % bs
        tokens[i, 1], lengths[i, 1] = gt[j], gl[j]
        tokens[i, 2], lengths[i, 2] = (gt[i], gl[i]) if i % 2 == 0 else (
            gt[(i + 2) % bs], gl[(i + 2) % bs])
        tokens[i, 3] = r.randint(0, cfg.dim_program_token, L)
        lengths[i, 3] = L
    scores = np.sort(r.randn(bs, 4).astype(np.float32), axis=1)[:, ::-1]
    perm = np.stack([r.permutation(4) for _ in range(bs)])
    evals = {"beam_tokens": np.take_along_axis(tokens, perm[:, :, None], 1),
             "beam_lengths": np.take_along_axis(lengths, perm, 1),
             "beam_scores": np.take_along_axis(scores.copy(), perm, 1)}
    return cfg, batch, tokens, lengths, evals


def test_rerank_pick_matches_jax(planted):
    """Beam 2 (the ground truth) wherever it reproduces every seen demo,
    beam 0 where no beam does; the same picks as the JAX scorer's."""
    cfg, batch, tokens, lengths, _ = planted
    want = JaxScorer(cfg).rerank_pick(tokens, lengths, batch)
    got = KarelScorer(cfg, "cpu").rerank_pick(tokens, lengths,
                                              to_device(batch, "cpu"))
    np.testing.assert_array_equal(got, want)
    assert (got[::2] == 2).all()


def test_apply_rerank_matches_jax(planted):
    """_apply_rerank sorts the beams by score, picks, and recomputes the
    picked programs' sequence and token accuracies: every eval array and
    the changed count equal the JAX evaler's."""
    cfg, batch, _, _, evals = planted
    jax_self = types.SimpleNamespace(
        args=types.SimpleNamespace(rerank_k=0, dataset_type="karel"),
        cfg=cfg, scorer=JaxScorer(cfg), _rerank_changed=0, _rerank_total=0)
    want = {k: v.copy() for k, v in evals.items()}
    JaxEvaler._apply_rerank(jax_self, batch, want)
    port_self = types.SimpleNamespace(
        args=types.SimpleNamespace(rerank_k=0), cfg=cfg,
        scorer=KarelScorer(cfg, "cpu"), _rerank_changed=0, _rerank_total=0)
    got = {k: v.copy() for k, v in evals.items()}
    Evaler._apply_rerank(port_self, to_device(batch, "cpu"), got)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert port_self._rerank_changed == jax_self._rerank_changed > 0
    assert port_self._rerank_total == jax_self._rerank_total == 4
    assert (got["greedy_is_same_seq"][::2] == 1).all()


def test_evaler_cli_beam_with_rerank(tmp_path, monkeypatch, log_records):
    """evaler_cli --device cpu --unroll_type beam --beam_width 3
    --execution_rerank after a 2-step train: the final report has
    rerank_changed_rate beside the usual accuracies."""
    split = generate_split(SPLIT)
    _, report = drive_clis("full", split, tmp_path, monkeypatch, log_records,
                           eval_flags=["--unroll_type", "beam",
                                       "--beam_width", "3",
                                       "--execution_rerank"])
    assert 0.0 <= report["Acc"]["rerank_changed_rate"] <= 1.0
    assert "greedy_exact_program_accuracy" in report["Acc"]


def test_rerank_k_is_vizdoom_only():
    """--rerank_k re-reads stored ViZDoom demos; on Karel it changes
    nothing, as in the JAX evaler (evaler.py:238-243): the same report as
    a run without it (tests/test_torch_vizdoom_eval.py holds its ViZDoom
    picks against JAX)."""
    split = generate_split(SPLIT)
    runs = []
    for extra in ([], ["--rerank_k", "5"]):
        args = evaler_cli.parse_args([
            "--dataset_path", "in-memory", "--num_k", str(SPLIT.k),
            "--batch_size", "4", "--num_lstm_cell_units", "16",
            "--device", "cpu", "--unroll_type", "beam", "--beam_width", "3",
            "--execution_rerank", "--max_steps", "1", "--quiet",
            "--no_write_summary", *extra])
        runs.append(Evaler(args, split, device="cpu").eval_run())
    (loss_a, acc_a, hist_a), (loss_b, acc_b, hist_b) = runs
    assert loss_a == loss_b and acc_a == acc_b
    assert "rerank_changed_rate" in acc_b
    assert set(hist_a) == set(hist_b)
    for k in hist_a:
        np.testing.assert_array_equal(hist_a[k], hist_b[k])
