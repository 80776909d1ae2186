"""The port's stage-S recipe runner (cli/recipe_cli.py) and the in-memory
three-way split it trains on (data/karel_memory.py:generate_splits).

The splits are held against the JAX package's HDF5 dataset of the same
generator settings: ids in the order of demo2program_tpu/data/dataset.py:
all_ids, every compact batch bit for bit, the same model config, and the id
list's hash equal to the written id.txt's. The runner is run at units 16,
bs 4 on that dataset: a run staged through --carry_dir must end bit for bit
where the run in one process ends. The selector must pick what the JAX
script picked from its committed val logs.
"""

import copy
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from demo2program_tpu.data import dataset as jax_dataset
from demo2program_tpu.data import karel_generator as jax_kg
from demo2program_tpu.train.trainer import (
    config_from_dataset as jax_config_from_dataset)
from demo2program_tpu_torch import native
from demo2program_tpu_torch.cli import recipe_cli, trainer_cli
from demo2program_tpu_torch.cli.recipe_cli import (
    Recipe, RecipeRefused, RecipeRun, select_step)
from demo2program_tpu_torch.data.dataset import split_ids
from demo2program_tpu_torch.data.karel_generator import GeneratorConfig
from demo2program_tpu_torch.data.karel_memory import (
    generate_splits, id_list_sha256, load_splits, save_splits, splits_sha256)
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VAL_LOGS = os.path.join(ROOT, "results", "r5", "karel25k_synthesis_s234")
SIZES = {"num_train": 24, "num_test": 8, "num_val": 8}
GEN = GeneratorConfig(**SIZES)  # seed 123, karel_25k's other settings
# the recipe at a small size: 12 steps, a checkpoint every 4, val at 4, 8
# and 12 with one batch each
SMALL = dict(max_steps=12, ckpt_save_step=4, test_sample_step=4, log_step=2,
             batch_size=4, num_lstm_cell_units=16, val_steps=(4, 8, 12),
             val_batches=1, eval_batch_size=4)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """The JAX generator's HDF5 dataset of GEN (python backend)."""
    out = tmp_path_factory.mktemp("karel_jax")
    jax_kg.generate(jax_kg.GeneratorConfig(
        **{**dataclasses.asdict(GEN), "dir_name": str(out)}),
        progress_every=0, backend="python")
    return str(out)


@pytest.fixture(scope="module")
def splits():
    return generate_splits(GEN, "python")


@pytest.fixture
def one_thread():
    """Runs compared bit for bit take one CPU thread: a threaded CPU matmul
    may sum in another order from one run to the next (the card runs in
    deterministic mode, train/step.py:deterministic_cuda)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recipe(splits, **kw):
    return Recipe(**{**SMALL, "split_sha256": splits[0].id_sha256, **kw})


@pytest.mark.parametrize("part", ["train", "test", "val"])
def test_generate_splits_are_jax_splits(jax_dir, splits, part):
    """(a) ids in all_ids' order and every compact array bit for bit."""
    i = ["train", "test", "val"].index(part)
    want_ids = jax_dataset.all_ids(jax_dir)[i]
    jax_split = jax_dataset.create_default_splits(jax_dir, num_k=10)[i]
    got = splits[i]
    assert got.ids == want_ids == list(jax_split.ids)
    want = jax_split.get_batch_compact(want_ids)
    have = got.get_batch_compact(want_ids)
    assert sorted(have) == sorted(want)
    for key in want:
        assert have[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(have[key], want[key], err_msg=key)


def test_generate_splits_config_and_hash(jax_dir, splits):
    """(a) the model config the port reads from the split is the one the
    JAX trainer reads from the file; id_list_sha256 hashes id.txt."""
    args = trainer_cli.parse_args(["--model", "synthesis_baseline"])
    jax_train = jax_dataset.create_default_splits(jax_dir, num_k=10)[0]
    want = dataclasses.asdict(jax_config_from_dataset(args, jax_train))
    have = dataclasses.asdict(config_from_dataset(args, splits[0]))
    assert {k: have[k] for k in want if k in have} == {
        k: want[k] for k in want if k in have}
    for key in ("max_program_len", "max_demo_len", "k", "test_k"):
        assert have[key] == want[key], key
    with open(os.path.join(jax_dir, "id.txt"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(os.path.join(jax_dir, "id.txt")) as f:
        assert id_list_sha256(f.read().split()) == digest
    assert all(s.id_sha256 == digest for s in splits)


@pytest.mark.parametrize("counts", [None, (20, 10, 6), (30, 0, 10)])
def test_split_ids_is_jax_all_ids(jax_dir, tmp_path, counts):
    """(b) split_ids = the JAX all_ids, also with a splits.json override."""
    with open(os.path.join(jax_dir, "id.txt")) as f:
        ids = f.read().split()
    path = jax_dir
    if counts is not None:
        path = str(tmp_path)
        os.symlink(os.path.join(jax_dir, "data.hdf5"),
                   os.path.join(path, "data.hdf5"))
        with open(os.path.join(path, "id.txt"), "w") as f:
            f.write("".join(i + "\n" for i in ids))
        with open(os.path.join(path, "splits.json"), "w") as f:
            f.write('{"num_train": %d, "num_test": %d, "num_val": %d}'
                    % counts)
    n = counts or (SIZES["num_train"], SIZES["num_test"], SIZES["num_val"])
    assert split_ids(ids, *n) == jax_dataset.all_ids(path)


def _train_state(out_dir, step):
    return checkpoint.load(checkpoint.checkpoint_path(
        os.path.join(out_dir, "train"), step))


def _assert_equal_states(a, b):
    assert a["step"] == b["step"]
    for key, t in a["model"].items():
        assert torch.equal(t, b["model"][key]), key
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for key in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][key]),
                               torch.as_tensor(sb[i][key])), (i, key)


SCORES = ("execution", "execution_unrounded",
          "greedy_exact_program_accuracy", "greedy_program_seq_acc")


def test_staged_run_equals_one_process(splits, tmp_path, one_thread):
    """(c) 12 steps in one process, and the same stopped at 8 through
    --carry_dir and resumed in a fresh directory: equal final train states
    bit for bit, the same best step and the same val and test reports."""
    recipe = _recipe(splits)
    one = RecipeRun(recipe, splits, str(tmp_path / "one"), device="cpu").run()
    carry = str(tmp_path / "carry")
    first = RecipeRun(recipe, splits, str(tmp_path / "a"), device="cpu",
                      until_step=8, carry_dir=carry).run()
    assert first["trained_step"] == 8 and first["test"] is None
    assert sorted(first["evals"], key=int) == ["4", "8"]
    # the carry holds the newest train checkpoint only
    assert checkpoint.checkpoint_steps(os.path.join(carry, "train")) == [8]
    assert os.listdir(os.path.join(carry, "best")) == [
        f"{first['best_step']}.pt"]
    staged = RecipeRun(recipe, splits, str(tmp_path / "b"), device="cpu",
                       resume_from=carry).run()
    for st in (one, staged):
        assert st["trained_step"] == 12 and st["test"] is not None
    _assert_equal_states(_train_state(str(tmp_path / "one"), 12),
                         _train_state(str(tmp_path / "b"), 12))
    assert staged["best_step"] == one["best_step"]
    assert staged["best_execution"] == one["best_execution"]
    for key in ("4", "8", "12"):
        for score in SCORES:
            assert staged["evals"][key][score] == one["evals"][key][score]
    for score in SCORES:
        assert staged["test"][score] == one["test"][score]
    assert staged["test"]["batches"] == len(splits[1].ids) // 4
    # a relaunch finds nothing left to do
    again = RecipeRun(recipe, splits, str(tmp_path / "b"), device="cpu").run()
    assert again["test"] == staged["test"]
    assert again["calls"][-1]["stages"] == []


def test_selector_picks_jax_step_from_committed_val_logs():
    """(d) JAX's val logs tie at 0.678 (20k and 30k); the script kept the
    earliest, 20000."""
    texts = {}
    for step in (20000, 25000, 30000):
        with open(os.path.join(JAX_VAL_LOGS, f"out_{step}_val.log")) as f:
            texts[step] = f.read()
    assert [recipe_cli.printed_execution(t) for t in texts.values()] == [
        0.678, 0.670, 0.678]
    assert select_step(texts, 30000) == (20000, 0.678)
    assert select_step({}, 30000) == (30000, None)


def test_refuses_another_split_or_state(splits, tmp_path):
    """(e) a split whose id list is not the recipe's, and a state made on
    another split or by another recipe, are refused before any step."""
    with pytest.raises(RecipeRefused, match="not the recipe's dataset"):
        RecipeRun(Recipe(), splits, str(tmp_path / "x"), device="cpu")
    recipe = _recipe(splits, max_steps=4, val_steps=(4,))
    out = str(tmp_path / "run")
    RecipeRun(recipe, splits, out, device="cpu", until_step=0).run()
    other = tuple(copy.copy(s) for s in splits)
    for s in other:
        s.id_sha256 = "0" * 64
    with pytest.raises(RecipeRefused, match="was made on a split"):
        RecipeRun(dataclasses.replace(recipe, split_sha256=""), other, out,
                  device="cpu")
    with pytest.raises(RecipeRefused, match="another recipe"):
        RecipeRun(dataclasses.replace(recipe, seed=1), splits, out,
                  device="cpu")
    with pytest.raises(RecipeRefused, match="fresh directory"):
        RecipeRun(recipe, splits, out, device="cpu", resume_from=out)
    assert not checkpoint.checkpoint_steps(os.path.join(out, "train"))


def test_split_file_round_trip_and_content_check(splits, tmp_path):
    """save_splits / load_splits give the same splits (contents hash
    equal), and a state made on a split is refused with a split of the
    same ids whose contents differ."""
    path = str(tmp_path / "splits.npz")
    save_splits(splits, path)
    loaded = load_splits(path)
    assert splits_sha256(loaded) == splits_sha256(splits)
    for a, b in zip(splits, loaded):
        assert a.ids == b.ids and a.id_sha256 == b.id_sha256
        for key in a.arr:
            assert a.arr[key].dtype == b.arr[key].dtype, key
            np.testing.assert_array_equal(a.arr[key], b.arr[key])
    recipe = _recipe(splits)
    out = str(tmp_path / "run")
    RecipeRun(recipe, splits, out, device="cpu", until_step=0).run()
    loaded[0].arr["c_wall"][0, 0, 0, 0] ^= 1
    with pytest.raises(RecipeRefused, match="contents hash"):
        RecipeRun(recipe, loaded, out, device="cpu")


def test_nothing_falls_back(splits, tmp_path, monkeypatch):
    """The native generator raises when the engine does not build, and the
    card asked for without one raises."""
    def no_build():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(native, "build", no_build)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        generate_splits(GEN)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RecipeRun(_recipe(splits), splits, str(tmp_path), device="cuda")


def test_cli_budget_stops_and_relaunch_finishes(tmp_path):
    """The CLI at a tiny size on the CPU (native generator): a budget that
    fits nothing records the state and trains nothing; the relaunch without
    one does the rest, on the split the first call wrote to --split_file."""
    out = str(tmp_path / "cli")
    argv = ["--out_dir", out, "--device", "cpu", "--split_sha256", "",
            "--split_file", str(tmp_path / "split.npz"),
            "--num_train", "24", "--num_test", "8", "--num_val", "8",
            *[f"--{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
              for k, v in SMALL.items()]]
    recipe_cli.main(argv + ["--budget_minutes", "0.5"])
    with open(os.path.join(out, "recipe_state.json")) as f:
        state = json.load(f)
    assert state["trained_step"] == 0 and not state["evals"]
    assert state["calls"][0]["generation"]["programs"] == 40
    assert state["calls"][0]["generation"]["how"] == "generated"
    recipe_cli.main(argv)
    with open(os.path.join(out, "recipe_report.json")) as f:
        report = json.load(f)
    assert [e["step"] for e in report["evals"]] == [4, 8, 12]
    assert report["test"]["split"] == "test"
    assert report["best_step"] in (4, 8, 12)
    assert [s["kind"] for s in report["stages"]] == [
        "train", "eval_val", "train", "eval_val", "train", "eval_val",
        "eval_test"]
    assert all(s["card"] == "cpu" for s in report["stages"])
    with open(os.path.join(out, "recipe_state.json")) as f:
        assert json.load(f)["calls"][1]["generation"]["how"] == "read"
