"""The eval slice end to end: the port vs the JAX package on the same data.

A seeded in-memory Karel split (tiny config: k=3, T=6, L=12, units=64)
feeds the same compact numpy batches to JAX `make_eval_step` + `KarelScorer`
and to the port's eval step + `KarelScorer`, with the flax variables (random,
non-trivial BN stats) converted and loaded through a `.pt` checkpoint by the
port's Evaler. Report scalars agree to atol 1e-4 (f32 sums in other
orders); greedy ids, syntax, exact-program and execution verdicts are exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from demo2program_tpu.eval.scorer import KarelScorer as JaxScorer
from demo2program_tpu.models.common import ModelConfig as JaxConfig
from demo2program_tpu.models.full import FullModel as JaxFullModel
from demo2program_tpu.ops.reconstruct import expand_batch as jax_expand
from demo2program_tpu.train.step import TrainState, make_eval_step as jax_step
from demo2program_tpu_torch.cli.evaler_cli import parse_args
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.eval.evaler import Evaler, config_from_dataset
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.train.step import make_eval_step, to_device

from tests.test_torch_models import GAP, _random_variables

ATOL = 1e-4
# what the JAX eval step returns for the trainer's image summaries: the port
# computes them only on request, and the Evaler does not ask
IMAGE_KEYS = {"pred_per", "pred_action_probs"}
BS, N_BATCHES = 4, 2
SPLIT = SplitConfig(num_programs=BS * N_BATCHES, seed=3, k=3, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)


def _batches(split):
    return [split.get_batch_compact(split.ids[s * BS:(s + 1) * BS])
            for s in range(N_BATCHES)]


@pytest.fixture(scope="module")
def slice_pair(tmp_path_factory):
    split = generate_split(SPLIT)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "model.pt")
    args = parse_args([
        "--dataset_path", "in-memory", "--checkpoint", ckpt,
        "--num_k", str(SPLIT.k), "--batch_size", str(BS),
        "--num_lstm_cell_units", "64", "--cell_impl", "pallas_jnp",
        "--max_steps", str(N_BATCHES), "--no_write_summary", "--quiet"])
    # the JAX side: the same config, random variables, one jitted step
    cfg = JaxConfig(**dataclasses.asdict(config_from_dataset(args, split)))
    model = JaxFullModel(cfg, train=False)
    first = {k: v for k, v in _batches(split)[0].items() if k != "id"}
    variables = _random_variables(model, jax_expand(first, cfg), seed=2)
    state = TrainState(step=np.zeros((), np.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None)
    step_j, scorer_j = jax_step(model, cfg, "full"), JaxScorer(cfg)
    jax_out = []
    for batch in _batches(split):
        report, evals = jax.device_get(step_j(state, batch))
        jax_out.append((report, evals, scorer_j.score_batch(batch, evals)))

    torch.save(flax_to_state_dict(variables["params"],
                                  variables["batch_stats"]), ckpt)
    evaler = Evaler(args, split, device="cpu")
    return split, evaler, jax_out, scorer_j


def _port_batch(evaler, batch):
    tb = to_device(batch, evaler.device)
    report, evals = evaler.eval_step(tb)
    evals = {k: v.numpy() for k, v in evals.items()}
    return report, evals, evaler.scorer.score_batch(tb, evals)


def _require_no_greedy_ties(evaler, batch):
    """Greedy ids are compared exactly; a top-2 logit gap below GAP would
    be an argmax tie, which the test reports and skips."""
    with torch.no_grad():
        out = evaler.model(expand_batch(to_device(batch, evaler.device),
                                        evaler.cfg))
    for key in ("greedy_program_logits", "greedy_action_logits"):
        top2 = out[key].topk(2, dim=-1).values
        gap = float((top2[..., 0] - top2[..., 1]).min())
        if gap < GAP:
            pytest.skip(f"{key}: top-2 gap {gap:.2e} < {GAP}, an argmax tie")


def test_eval_step_and_scores_match_jax(slice_pair):
    split, evaler, jax_out, _ = slice_pair
    with_images = make_eval_step(evaler.model, evaler.cfg, "full",
                                 image_tensors=True)
    for batch, (rep_j, ev_j, sc_j) in zip(_batches(split), jax_out):
        _require_no_greedy_ties(evaler, batch)
        rep_t, ev_t, sc_t = _port_batch(evaler, batch)
        assert set(rep_t) == set(rep_j)
        for k in rep_j:
            np.testing.assert_allclose(float(rep_t[k]), float(rep_j[k]),
                                       atol=ATOL, rtol=0, err_msg=k)
        # every tensor; the image summaries' pred_per and
        # pred_action_probs from the step that asks for them
        assert set(ev_j) - set(ev_t) == IMAGE_KEYS
        _, images = with_images(to_device(batch, evaler.device))
        assert set(images) == set(ev_j)
        ev_t.update({k: images[k].numpy() for k in IMAGE_KEYS})
        for k in ev_t:
            want = np.asarray(ev_j[k])
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(ev_t[k], want, err_msg=k)
            else:
                np.testing.assert_allclose(ev_t[k], want, atol=ATOL, rtol=0,
                                           err_msg=k)
        assert set(sc_t) == set(sc_j)
        for k in sc_j:  # syntax, exact and execution verdicts + hists
            np.testing.assert_array_equal(np.asarray(sc_t[k]),
                                          np.asarray(sc_j[k]), err_msg=k)


def _swap_one_action(tokens, lens, vocab, rng):
    """Ground-truth programs with one action token swapped: they still
    parse, and many stop reproducing their demos."""
    tokens = tokens.copy()
    actions = [vocab.token2int[t] for t in vocab.action_functions]
    for i in range(len(tokens)):
        pos = [j for j in range(lens[i]) if tokens[i, j] in actions]
        j = pos[rng.randint(len(pos))]
        tokens[i, j] = actions[(actions.index(tokens[i, j]) + 1) % 5]
    return tokens


def test_scorer_matches_jax_on_mutated_ground_truth(slice_pair):
    """Ground truth scores execution 1.0 on seen and unseen demos; the
    mutated programs get the same verdicts from both scorers."""
    split, evaler, _, scorer_j = slice_pair
    rng = np.random.RandomState(1)
    for batch in _batches(split):
        lens = batch["program_len"][:, 0].astype(np.int32)
        same = np.zeros(BS, np.float32)
        tb = to_device(batch, "cpu")
        for test, k in ((False, SPLIT.k), (True, SPLIT.test_k)):
            nc, _ = evaler.scorer.execution_compact(
                batch["program_tokens"], lens, same, tb, test=test)
            assert (nc == k).all()
        evals = {"greedy_tokens": _swap_one_action(
                     batch["program_tokens"], lens, evaler.vocab, rng),
                 "greedy_len": lens, "greedy_is_same_seq": same}
        sc_t = evaler.scorer.score_batch(tb, evals)
        sc_j = scorer_j.score_batch(batch, evals)
        assert set(sc_t) == set(sc_j)
        for k in sc_j:
            np.testing.assert_array_equal(np.asarray(sc_t[k]),
                                          np.asarray(sc_j[k]), err_msg=k)


def test_full_tensor_execution_matches_jax(slice_pair):
    """KarelScorer.execution on full (bs, k, T, h, w, 16) demo tensors
    (decode_states + VM), ground truth and mutated programs."""
    split, evaler, _, scorer_j = slice_pair
    cfg = JaxConfig(**dataclasses.asdict(evaler.cfg))
    batch = _batches(split)[0]
    s_h = np.array(jax_expand(
        {k: v for k, v in batch.items() if k != "id"}, cfg)["s_h"])
    lens = batch["program_len"][:, 0].astype(np.int32)
    same = np.zeros(BS, np.float32)
    for tokens in (batch["program_tokens"], _swap_one_action(
            batch["program_tokens"], lens, evaler.vocab,
            np.random.RandomState(2))):
        nc_t, per_t = evaler.scorer.execution(tokens, lens, same, s_h,
                                              batch["demo_len"])
        nc_j, per_j = scorer_j.execution(tokens, lens, same, s_h,
                                         batch["demo_len"])
        np.testing.assert_array_equal(nc_t, nc_j)
        np.testing.assert_array_equal(per_t, per_j)
    assert (evaler.scorer.execution(batch["program_tokens"], lens, same, s_h,
                                    batch["demo_len"])[0] == SPLIT.k).all()


def test_eval_run_averages_match_jax(slice_pair):
    """Evaler.eval_run over the split: the final averages are the means of
    the JAX per-batch reports and scores."""
    _, evaler, jax_out, _ = slice_pair
    loss_avg, acc_avg, hist_avg = evaler.eval_run()
    want_loss = np.mean([float(r["loss"]) for r, _, _ in jax_out])
    np.testing.assert_allclose(loss_avg["loss"], want_loss, atol=ATOL,
                               rtol=0)
    want_syntax = np.mean([s["greedy_program_syntax_acc"]
                           for _, _, s in jax_out])
    assert acc_avg["greedy_program_syntax_acc"] == pytest.approx(want_syntax)
    want_hist = np.mean([s["test_greedy_program_execution_acc_hist"]
                         for _, _, s in jax_out], axis=0)
    np.testing.assert_allclose(
        hist_avg["test_greedy_program_execution_acc_hist"], want_hist)
    assert all(len(v) == N_BATCHES for v in evaler.timings.values())


def test_cli_evaluates_an_hdf5_split(tmp_path):
    """`python -m demo2program_tpu_torch.cli.evaler_cli` on a dataset from
    the JAX package's generator: random init from --seed, summary file."""
    from demo2program_tpu.data.karel_generator import GeneratorConfig, generate
    from demo2program_tpu_torch.cli import evaler_cli

    d = str(tmp_path / "karel")
    generate(GeneratorConfig(
        dir_name=d, num_train=2, num_test=4, num_val=0, seed=9,
        num_demo_per_program=3, num_test_demo_per_program=2,
        min_demo_length=3, max_demo_length=8), progress_every=0,
        backend="python")
    summary = tmp_path / "report.txt"
    evaler_cli.main(["--dataset_path", d, "--num_k", "3", "--batch_size",
                     "2", "--num_lstm_cell_units", "16", "--quiet",
                     "--device", "cpu",
                     "--summary_file", str(summary)])
    text = summary.read_text()
    assert "[Final Avg Report]" in text and "Checkpoint: \n" in text
    assert "test_greedy_program_execution_acc_hist" in text
