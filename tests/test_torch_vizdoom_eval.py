"""The port's ViZDoom scoring and entry points, on the CPU: VizdoomScorer
and the --rerank_k re-read against the JAX package's, the three CLIs end
to end (generator -> trainer -> evaler, greedy and beam with rerank),
bitwise exact resume, and the default summary file's name against the JAX
CLI's (Karel and ViZDoom)."""

import json
import os
import re
import types

import numpy as np
import pytest
import torch

from demo2program_tpu.data.vizdoom_dataset import (
    create_vizdoom_splits as jax_splits)
from demo2program_tpu.data.vizdoom_generator import (
    VizdoomGeneratorConfig as JaxGeneratorConfig, generate as jax_generate)
from demo2program_tpu.eval.evaler import Evaler as JaxEvaler
from demo2program_tpu.eval.vizdoom_scorer import (
    VizdoomScorer as JaxVizdoomScorer)
from demo2program_tpu_torch.cli import (
    evaler_cli, trainer_cli, vizdoom_generator_cli)
from demo2program_tpu_torch.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu_torch.eval.evaler import Evaler, config_from_dataset
from demo2program_tpu_torch.eval.vizdoom_scorer import VizdoomScorer
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.trainer import Trainer
from tests.test_torch_trainer import log_records  # noqa: F401 (fixture)

BS, K = 4, 3
GEN = dict(num_train=8, num_test=4, num_val=0, seed=11,
           num_demo_per_program=5, num_test_demo_per_program=2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A ViZDoom HDF5 dataset of the JAX generator, 5 seen demos stored ->
    (path, the port's test split at num_k 3, the JAX one)."""
    path = str(tmp_path_factory.mktemp("vizdoom") / "d")
    jax_generate(JaxGeneratorConfig(dir_name=path, **GEN))
    return (path, create_vizdoom_splits(path, num_k=K)[1],
            jax_splits(path, num_k=K)[1])


def _mixed_predictions(batch, vocab):
    """Per row: the ground truth (is_same_seq 0, so it is executed), the
    next row's program (wrong, or right by execution), a truncated
    program (unparsable), and the ground truth flagged as the same
    sequence."""
    tokens = batch["program_tokens"].copy()
    lens = batch["program_len"][:, 0].astype(np.int32).copy()
    same = np.zeros(len(tokens), np.float32)
    tokens[1], lens[1] = batch["program_tokens"][2], lens[2]
    lens[2] = max(lens[2] // 2, 1)
    same[3] = 1.0
    return tokens, lens, same


def test_scorer_matches_jax(dataset):
    """Syntax, canonical and execution verdicts (seen and unseen demos) of
    both scorers on a batch mixing correct, wrong and unparsable programs:
    equal, exactly."""
    _, split, _ = dataset
    cfg = config_from_dataset(trainer_cli.parse_args(
        ["--dataset_type", "vizdoom", "--num_k", str(K)]), split)
    batch = split.get_batch(split.ids[:BS])
    scorer_t = VizdoomScorer(cfg)
    scorer_j = JaxVizdoomScorer(cfg)
    tokens, lens, same = _mixed_predictions(batch, scorer_t.vocab)
    evals = {"pred_tokens": tokens, "pred_len": lens,
             "pred_is_same_seq": same, "greedy_tokens": tokens[::-1].copy(),
             "greedy_len": lens[::-1].copy(),
             "greedy_is_same_seq": same[::-1].copy()}
    got = scorer_t.score_batch(batch, evals)
    want = scorer_j.score_batch(batch, evals)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    # the ground truth reproduces every demo, the truncation parses nowhere
    assert got["program_num_execution_correct"][0] == K
    assert got["is_correct_syntax"][2] == 0
    assert scorer_t.timings["vm"] > 0


def test_rerank_k_picks_match_jax(dataset):
    """--rerank_k: the re-read of 5 stored seen demos for a model that read
    3 equals the JAX evaler's, and both scorers pick the same beams from
    planted beam sets (a wrong program, an unparsable one, the ground
    truth), over the 3 demos and over the 5."""
    _, split, split_j = dataset
    batch = split.get_batch(split.ids[:BS])
    got = Evaler._full_k_rerank_arrays(
        types.SimpleNamespace(dataset=split), batch, 5)
    want = JaxEvaler._full_k_rerank_arrays(
        types.SimpleNamespace(dataset=split_j), batch, 5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert got["s_h"].shape[1] == 5

    cfg = config_from_dataset(trainer_cli.parse_args(
        ["--dataset_type", "vizdoom", "--num_k", str(K)]), split)
    gt = batch["program_tokens"]
    gt_len = batch["program_len"][:, 0].astype(np.int32)
    beams = np.stack([np.roll(gt, 1, axis=0), gt, gt], axis=1)
    beam_lens = np.stack([np.roll(gt_len, 1), np.maximum(gt_len // 2, 1),
                          gt_len], axis=1)
    for arrays in (batch, got):
        pick_t = VizdoomScorer(cfg).rerank_pick(beams, beam_lens, arrays)
        pick_j = JaxVizdoomScorer(cfg).rerank_pick(beams, beam_lens, arrays)
        np.testing.assert_array_equal(pick_t, pick_j)
        assert set(pick_t.tolist()) <= {0, 2}


def _train_args(train_dir, dataset_path, *extra):
    return trainer_cli.parse_args([
        "--device", "cpu", "--dataset_type", "vizdoom",
        "--dataset_path", dataset_path, "--train_dir", str(train_dir),
        "--num_k", str(K), "--batch_size", str(BS),
        "--num_lstm_cell_units", "16", "--log_step", "2",
        "--test_sample_step", "2", "--ckpt_save_step", "2", "--seed", "0",
        *extra])


def test_exact_resume_is_bitwise(dataset, tmp_path):
    """ViZDoom on the device cache: 2 steps, then a new Trainer resuming to
    4 == 4 uninterrupted steps, bitwise (parameters, buffers, Adam)."""
    path, _, _ = dataset
    train, test = create_vizdoom_splits(path, num_k=K)[:2]
    whole = Trainer(_train_args(tmp_path / "whole", path), train, test,
                    device="cpu")
    whole.train(max_steps=4)
    part = Trainer(_train_args(tmp_path / "part", path), train, test,
                   device="cpu")
    part.train(max_steps=2)
    with open(os.path.join(part.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": 4}, f)
    resumed = Trainer(_train_args(tmp_path / "part", path), train, test,
                      device="cpu")
    assert resumed._auto_resumed and resumed.state.step == 2
    resumed.train(max_steps=4)
    want, got = whole.state.state_dict(), resumed.state.state_dict()
    assert got["step"] == want["step"] == 4
    for k in want["model"]:
        assert torch.equal(got["model"][k], want["model"][k]), k
    opt_got = got["optimizer"]["state"]
    for i, st in want["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(opt_got[i][k]),
                               torch.as_tensor(v)), (i, k)


def _final_report(path):
    text = open(path).read()
    report = {}
    for section, body in re.findall(r"\[(Loss|Acc)\]\s*(.*?)(?=\n\[)",
                                    text, re.S):
        report[section] = {k: float(v) for k, v in re.findall(
            r"(\w+):\s*(-?[\d.]+|nan|-?inf)", body)}
    return report


def test_clis_drive_vizdoom(tmp_path, log_records):  # noqa: F811
    """The generator CLI writes a dataset; trainer_cli trains 4 steps on it
    and a relaunch has nothing to do; evaler_cli evaluates the newest
    checkpoint greedily and with beam search + execution rerank over 5
    stored seen demos (the model reads 3)."""
    vizdoom_generator_cli.main([
        "--dir_name", "tiny", "--datasets_root", str(tmp_path),
        "--num_train", "6", "--num_test", "4", "--num_val", "0",
        "--num_demo_per_program", "5", "--num_test_demo_per_program", "2",
        "--seed", "3"])
    data = str(tmp_path / "tiny_len8_seed3")
    assert os.path.exists(os.path.join(data, "data.hdf5"))
    train_dir = str(tmp_path / "train")
    common = ["--device", "cpu", "--dataset_type", "vizdoom",
              "--dataset_path", data, "--num_k", str(K), "--batch_size", "2",
              "--num_lstm_cell_units", "16"]
    argv = common + ["--train_dir", train_dir, "--max_steps", "4",
                     "--log_step", "1", "--ckpt_save_step", "2"]
    trainer_cli.main(argv)
    assert checkpoint.checkpoint_steps(train_dir) == [2, 4]
    trainer_cli.main(argv)
    assert any("already reached" in r.getMessage() for r in log_records)
    for flags in ([], ["--unroll_type", "beam", "--beam_width", "3",
                       "--execution_rerank", "--rerank_k", "5"]):
        summary = str(tmp_path / f"report{len(flags)}.txt")
        evaler_cli.main(common + ["--train_dir", train_dir, "--quiet",
                                  "--summary_file", summary, *flags])
        report = _final_report(summary)
        assert set(report) == {"Loss", "Acc"}
        assert all(np.isfinite(v) for d in report.values()
                   for v in d.values())
        assert ("rerank_changed_rate" in report["Acc"]) == bool(flags)


@pytest.mark.parametrize("dataset_type", ["karel", "vizdoom"])
def test_default_summary_name_matches_jax(dataset_type, tmp_path,
                                          monkeypatch):
    """One argv without --max_steps or --summary_file through both
    evaluation CLIs: the default summary file is named alike,
    `_report_testdata{batches x bs}_num_k{K}.txt` (the port's used to say
    testdata0)."""
    from demo2program_tpu.cli import evaler_cli as jax_cli

    d = str(tmp_path / "data")
    if dataset_type == "karel":
        from demo2program_tpu.data.karel_generator import (
            GeneratorConfig, generate)
        generate(GeneratorConfig(
            dir_name=d, num_train=4, num_test=5, num_val=0, seed=9,
            num_demo_per_program=3, num_test_demo_per_program=2,
            min_demo_length=3, max_demo_length=8), progress_every=0,
            backend="python")
    else:
        jax_generate(JaxGeneratorConfig(
            dir_name=d, num_train=2, num_test=5, num_val=0, seed=5,
            num_demo_per_program=3, num_test_demo_per_program=2))
    names = {}

    def record(package):
        def eval_run(self):
            names[package] = self.summary_file
        return eval_run

    monkeypatch.setattr(JaxEvaler, "eval_run", record("jax"))
    monkeypatch.setattr(Evaler, "eval_run", record("port"))
    argv = ["--dataset_type", dataset_type, "--dataset_path", d,
            "--num_k", "3", "--batch_size", "2",
            "--num_lstm_cell_units", "16"]
    jax_cli.main(argv)
    evaler_cli.main(argv + ["--device", "cpu"])
    assert names["port"] == names["jax"] == \
        "_report_testdata4_num_k3.txt"
