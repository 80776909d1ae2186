"""The port's trainer end to end on the CPU, tiny config: device cache,
cadence and artifacts, exact resume, warm start, checkpoints read by the
Evaler, both CLIs, and the explicit device (no CPU fallback)."""

import json
import logging
import os
import re

import numpy as np
import pytest
import torch

from demo2program_tpu_torch.cli import evaler_cli, trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.eval.evaler import Evaler
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.device_cache import KarelDeviceCache
from demo2program_tpu_torch.train.trainer import Trainer
from demo2program_tpu_torch.utils import log

BS, STEPS = 4, 4
SPLIT = SplitConfig(num_programs=10, seed=11, k=3, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)


@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


def _args(train_dir, *extra):
    return trainer_cli.parse_args([
        "--device", "cpu", "--dataset_path", "in-memory",
        "--train_dir", str(train_dir), "--num_k", str(SPLIT.k),
        "--batch_size", str(BS), "--num_lstm_cell_units", "32",
        "--cell_impl", "pallas", "--log_step", "2", "--test_sample_step", "2",
        "--ckpt_save_step", "2", "--seed", "0", *extra])


def _run(split, train_dir, max_steps, *extra):
    trainer = Trainer(_args(train_dir, *extra), split, split, device="cpu")
    trainer.train(max_steps=max_steps)
    return trainer


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    """4 uninterrupted steps."""
    return _run(split, tmp_path_factory.mktemp("a"), STEPS)


@pytest.fixture
def log_records():
    """The package logger does not propagate; collect its records here."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log.addHandler(handler)
    yield records
    log.removeHandler(handler)


# -- device cache --------------------------------------------------------------

def test_cache_epochs_are_permutations(split):
    """Each epoch visits steps_per_epoch * bs distinct rows (without
    replacement), in an order that changes from epoch to epoch."""
    cache = KarelDeviceCache(split, "cpu", 3, seed=4)
    per_epoch = cache.steps_per_epoch
    assert per_epoch == len(split.ids) // 3
    epochs = [torch.cat([cache.indices(e * per_epoch + s)
                         for s in range(per_epoch)]).tolist()
              for e in range(3)]
    for e, rows in enumerate(epochs):
        assert len(set(rows)) == len(rows) == per_epoch * 3
        assert sorted(cache.permutation(e)) == list(range(len(split.ids)))
    assert epochs[0] != epochs[1]


def test_cache_batch_is_a_function_of_seed_and_step(split):
    """Two caches with one seed serve the same batches, also when one is
    first asked at step 5 (a restart); another seed serves others."""
    a = KarelDeviceCache(split, "cpu", BS, seed=7)
    restarted = KarelDeviceCache(split, "cpu", BS, seed=7)
    seq = [a.indices(s).tolist() for s in range(8)]
    assert [restarted.indices(s).tolist() for s in range(5, 8)] == seq[5:]
    other = KarelDeviceCache(split, "cpu", BS, seed=8)
    assert [other.indices(s).tolist() for s in range(8)] != seq


def test_cache_rows_equal_get_batch_compact(split):
    """A gathered batch is get_batch_compact of the chosen ids, without the
    ids and the unseen-demo arrays."""
    cache = KarelDeviceCache(split, "cpu", BS, seed=1)
    for step in (0, 3):
        idx = cache.indices(step).tolist()
        want = split.get_batch_compact([split.ids[i] for i in idx])
        got = cache.batch(step)
        assert set(got) == {k for k in want
                            if k != "id" and not k.startswith("test_")}
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


# -- trainer -------------------------------------------------------------------

def test_trainer_writes_its_artifacts(trained):
    d = trained.train_dir
    rows = [json.loads(line) for line in open(os.path.join(d,
                                                           "metrics.jsonl"))]
    assert [(r["split"], r["step"]) for r in rows] == [
        ("val", 0), ("train", 2), ("val", 2), ("train", 4)]
    train_rows = [r for r in rows if r["split"] == "train"]
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0
               for r in train_rows)
    assert json.load(open(os.path.join(d, "resume.json"))) == {
        "target_step": STEPS}
    assert checkpoint.checkpoint_steps(d) == [2, 4]
    samples = open(os.path.join(d, "samples.txt")).read()
    assert samples.count("# step") == 2 and "greedy: " in samples
    assert trained.state.step == STEPS


def test_exact_resume_is_bitwise(split, trained, tmp_path):
    """2 steps, a new Trainer on the same train_dir auto-resuming to 4 ==
    4 uninterrupted steps, bitwise on every parameter and buffer and on the
    Adam state (counterpart of tests/test_exact_resume.py)."""
    first = _run(split, tmp_path, 2)
    with open(os.path.join(first.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": STEPS}, f)
    resumed = Trainer(_args(tmp_path), split, split, device="cpu")
    assert resumed._auto_resumed and resumed.state.step == 2
    resumed.train(max_steps=STEPS)
    assert resumed.state.step == STEPS
    want, got = trained.model.state_dict(), resumed.model.state_dict()
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    opt_want = trained.state.optimizer.state_dict()["state"]
    opt_got = resumed.state.optimizer.state_dict()["state"]
    for i in opt_want:
        for k in opt_want[i]:
            assert torch.equal(opt_got[i][k], opt_want[i][k]), (i, k)


def test_exact_resume_is_bitwise_with_scheduled_sampling(split, trained,
                                                         tmp_path,
                                                         monkeypatch):
    """With --scheduled_sampling the draws of step s are a pure function of
    (seed, s): 2 steps and an auto-resume to 4 == 4 uninterrupted steps,
    bitwise; and the samples were used (the parameters differ from the
    teacher-forced run's)."""
    flags = ("--scheduled_sampling", "--scheduled_sampling_decay_steps", "2")
    whole = _run(split, tmp_path / "whole", STEPS, *flags)
    first = _run(split, tmp_path / "parts", 2, *flags)
    with open(os.path.join(first.train_dir, "resume.json"), "w") as f:
        json.dump({"target_step": STEPS}, f)
    resumed = Trainer(_args(tmp_path / "parts", *flags), split, split,
                      device="cpu")
    assert resumed._auto_resumed and resumed.state.step == 2
    resumed.train(max_steps=STEPS)
    want, got = whole.model.state_dict(), resumed.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    teacher_forced = trained.model.state_dict()
    assert any(not torch.equal(want[k], teacher_forced[k]) for k in want)
    monkeypatch.chdir(tmp_path)  # a run without --train_dir names its own
    assert "_sd_2_" in Trainer(_args("", *flags), split, split,
                               device="cpu").train_dir


def test_relaunch_has_nothing_to_do(split, trained, log_records):
    before = dict(trained.model.state_dict())
    again = Trainer(_args(trained.train_dir), split, split, device="cpu")
    again.train(max_steps=STEPS)
    assert any("Nothing to do" in r.getMessage() for r in log_records)
    assert again.state.step == STEPS
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer_cli._stage_already_done(trained.train_dir)


def test_warm_start_from_checkpoint(split, trained, tmp_path):
    """--checkpoint into a fresh train_dir takes the whole train state of
    a trainer checkpoint, and the parameters of a bare state_dict."""
    ckpt = checkpoint.checkpoint_path(trained.train_dir, 2)
    warm = Trainer(_args(tmp_path / "w", "--checkpoint", ckpt), split, split,
                   device="cpu")
    assert warm.state.step == 2
    saved = checkpoint.load(ckpt)["model"]
    for k, v in warm.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    bare = tmp_path / "bare.pt"
    torch.save(saved, bare)
    warm = Trainer(_args(tmp_path / "b", "--checkpoint", str(bare)), split,
                   split, device="cpu")
    assert warm.state.step == 0
    assert torch.equal(warm.model.state_dict()["program_decoder.core."
                                               "cell.kernel"],
                       saved["program_decoder.core.cell.kernel"])


def test_evaler_reads_trainer_checkpoints(split, trained):
    """By --checkpoint (a trainer checkpoint) and by --train_dir (its
    newest checkpoint): the trained weights, evaluated for one batch."""
    ckpt = checkpoint.checkpoint_path(trained.train_dir, STEPS)
    for flags in (["--checkpoint", ckpt],
                  ["--train_dir", trained.train_dir]):
        args = evaler_cli.parse_args([
            "--dataset_path", "in-memory", "--num_k", str(SPLIT.k),
            "--batch_size", str(BS), "--num_lstm_cell_units", "32",
            "--cell_impl", "pallas", "--max_steps", "1", "--quiet",
            "--no_write_summary", "--device", "cpu", *flags])
        evaler = Evaler(args, split, device=args.device)
        assert evaler.checkpoint == ckpt
        for k, v in trained.model.state_dict().items():
            assert torch.equal(evaler.model.state_dict()[k], v), k
        loss, _, _ = evaler.eval_run()
        assert np.isfinite(loss["loss"])


def test_unported_options_raise(split, tmp_path):
    """What stays unported raises: a JAX orbax checkpoint directory as
    --checkpoint (reading it needs orbax and jax; models/convert.py brings
    flax variables over). --sample_images and --profile_steps are ported
    (tests/test_torch_pipeline.py) and build a Trainer."""
    orbax_dir = tmp_path / "ckpt" / "20" / "default"
    orbax_dir.mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        Trainer(_args(tmp_path / "run", "--checkpoint", str(orbax_dir)),
                split, split, device="cpu")
    for extra in (["--sample_images"], ["--profile_steps", "3"]):
        Trainer(_args(tmp_path / extra[0][2:], *extra), split, split,
                device="cpu").close()


# -- the explicit device -------------------------------------------------------

def test_cuda_without_a_card_raises(split, tmp_path, monkeypatch):
    """The default device is the card, and without one every entry point
    raises: nothing falls back to the CPU (the evaler used to)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    train_args = _args(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(train_args, split, split)
    eval_args = evaler_cli.parse_args(["--num_k", str(SPLIT.k)])
    assert eval_args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaler(eval_args, split)
    missing = str(tmp_path / "no_dataset")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer_cli.main(["--dataset_path", missing])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaler_cli.main(["--dataset_path", missing])


def test_trainer_on_the_card_requires_deterministic_mode(split, tmp_path,
                                                         monkeypatch):
    """The Trainer sets no process-wide mode: on the card it raises, before
    any CUDA work, unless the entry point turned on deterministic
    algorithms and set cuBLAS's workspace (train/step.py:
    deterministic_cuda); either alone is not enough."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(RuntimeError, match="deterministic kernels"):
        Trainer(_args(tmp_path), split, split, device="cuda")
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
            Trainer(_args(tmp_path), split, split, device="cuda")
    finally:
        torch.use_deterministic_algorithms(False)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with pytest.raises(RuntimeError, match="deterministic algorithms: "
                                           "False"):
        Trainer(_args(tmp_path), split, split, device="cuda")


def drive_clis(model_name, split, tmp_path, monkeypatch, records,
               eval_flags=()):
    """`trainer_cli.main` for 2 steps, its relaunch (which must log
    "Nothing to do"), then `evaler_cli.main` on the newest checkpoint with
    `eval_flags`, all with --device cpu --model `model_name`; the port's
    dataset reader serves the in-memory `split` as every split. -> (train_dir, {section: {metric:
    value}} of the evaler's final report, "Loss" and "Acc")."""
    from demo2program_tpu_torch.data import dataset

    monkeypatch.setattr(dataset, "create_default_splits",
                        lambda *a, **kw: (split, split, split))
    train_dir = str(tmp_path / "train")
    summary = str(tmp_path / "report.txt")
    common = ["--device", "cpu", "--model", model_name,
              "--dataset_path", "in-memory", "--num_k", str(SPLIT.k),
              "--batch_size", str(BS), "--num_lstm_cell_units", "16"]
    argv = common + ["--train_dir", train_dir, "--max_steps", "2",
                     "--log_step", "1", "--test_sample_step", "2",
                     "--ckpt_save_step", "2"]
    trainer_cli.main(argv)
    assert checkpoint.checkpoint_steps(train_dir) == [2]
    trainer_cli.main(argv)
    assert any("Nothing to do" in r.getMessage() for r in records)
    evaler_cli.main(common + ["--train_dir", train_dir, "--max_steps", "1",
                              "--quiet", "--summary_file", summary,
                              *eval_flags])
    text = open(summary).read()
    assert f"Model class: {model_name}" in text
    report = {}
    for section, body in re.findall(r"\[(Loss|Acc)\]\s*(.*?)(?=\n\[)",
                                    text, re.S):
        report[section] = {k: float(v) for k, v in re.findall(
            r"(\w+):\s*(-?[\d.]+|nan|-?inf)", body)}
    assert set(report) == {"Loss", "Acc"}
    assert all(np.isfinite(v) for d in report.values() for v in d.values())
    return train_dir, report


def test_cli_trains_an_hdf5_split(tmp_path, log_records):
    """`python -m demo2program_tpu_torch.cli.trainer_cli` on a dataset from
    the JAX package's generator; a relaunch stops before loading data."""
    from demo2program_tpu.data.karel_generator import GeneratorConfig, generate

    d = str(tmp_path / "karel")
    generate(GeneratorConfig(
        dir_name=d, num_train=6, num_test=4, num_val=0, seed=9,
        num_demo_per_program=3, num_test_demo_per_program=2,
        min_demo_length=3, max_demo_length=8), progress_every=0,
        backend="python")
    train_dir = str(tmp_path / "train")
    argv = ["--dataset_path", d, "--num_k", "3", "--batch_size", "2",
            "--num_lstm_cell_units", "16", "--train_dir", train_dir,
            "--max_steps", "3", "--log_step", "1", "--ckpt_save_step", "2",
            "--device", "cpu"]
    trainer_cli.main(argv)
    assert checkpoint.checkpoint_steps(train_dir) == [2, 3]
    trainer_cli.main(argv)
    assert any("already reached" in r.getMessage() for r in log_records)
