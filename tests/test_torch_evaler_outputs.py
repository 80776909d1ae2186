"""The evaler's dumps, the checkpoint sweep, `--id_list` and the offline tools
of the port vs the JAX package's, on the CPU.

One tiny HDF5 Karel dataset (the JAX generator's) and one set of random flax
variables (synthesis baseline, units 16), saved as an orbax checkpoint
`ckpt/7/default` for the JAX CLI and, converted with models/convert.py, as
`ckpt/7.pt` for the port's. The same argv (but `--device cpu`, which only
the port has, and each side's own checkpoint and output paths) runs through
both `evaler_cli.main`; the files they write must hold the same text and the
same HDF5 keys and values. f32, greedy decoding: the decoded ids must be
equal, so the variables' seed is one without an argmax tie.
"""

import dataclasses
import os
import re
import shutil
import sys

import h5py
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from demo2program_tpu.cli import evaler_cli as jax_cli
from demo2program_tpu.data.karel_generator import GeneratorConfig, generate
from demo2program_tpu.models.common import ModelConfig as JaxConfig
from demo2program_tpu.models.registry import (
    get_model_class as jax_model_class)
from demo2program_tpu.ops.reconstruct import expand_batch as jax_expand
from demo2program_tpu.tools import (
    eval_execution as jax_eval_execution, inspect_output as jax_inspect)
from demo2program_tpu_torch.cli import evaler_cli
from demo2program_tpu_torch.data.dataset import create_default_splits
from demo2program_tpu_torch.eval import evaler as evaler_module
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.models.convert import flax_to_state_dict
from demo2program_tpu_torch.tools import eval_execution, inspect_output
from tests.test_torch_models import _random_variables

MODEL, STEP, BS, K = "synthesis_baseline", 7, 4, 3
COMMON = ["--model", MODEL, "--num_k", str(K), "--batch_size", str(BS),
          "--num_lstm_cell_units", "16", "--dataset_split", "test",
          "--quiet"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Dataset dir, the two train_dirs with the same weights, the argv."""
    root = tmp_path_factory.mktemp("outputs")
    data = str(root / "karel")
    generate(GeneratorConfig(
        dir_name=data, num_train=2, num_test=8, num_val=0, seed=9,
        num_demo_per_program=K, num_test_demo_per_program=2,
        min_demo_length=3, max_demo_length=8), progress_every=0,
        backend="python")
    argv = ["--dataset_path", data] + COMMON
    args = evaler_cli.parse_args(argv + ["--device", "cpu"])
    split = create_default_splits(data, num_k=K, is_train=False)[1]
    cfg = JaxConfig(**dataclasses.asdict(config_from_dataset(args, split)))
    batch = {k: v for k, v in split.get_batch_compact(
        split.ids[:BS]).items() if k != "id"}
    variables = _random_variables(
        jax_model_class(MODEL)(cfg, train=False), jax_expand(batch, cfg),
        seed=2)
    jax_dir, torch_dir = str(root / "jax_run"), str(root / "torch_run")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.join(jax_dir, "ckpt", str(STEP), "default"),
               {"params": variables["params"],
                "batch_stats": variables["batch_stats"]})
    ckptr.wait_until_finished()
    os.makedirs(os.path.join(torch_dir, "ckpt"))
    torch.save(flax_to_state_dict(variables["params"],
                                  variables["batch_stats"]),
               os.path.join(torch_dir, "ckpt", f"{STEP}.pt"))
    return {"root": root, "data": data, "argv": argv, "jax_dir": jax_dir,
            "torch_dir": torch_dir}


@pytest.fixture(scope="module")
def dumps(world):
    """Both CLIs with --pred_program --result_data -> their output dirs."""
    out = {}
    for side, main, train_dir, extra in (
            ("jax", jax_cli.main, world["jax_dir"], []),
            ("torch", evaler_cli.main, world["torch_dir"],
             ["--device", "cpu"])):
        out_dir = str(world["root"] / f"out_{side}")
        main(world["argv"] + extra + [
            "--train_dir", train_dir, "--output_dir", out_dir,
            "--pred_program", "--result_data", "--result_data_path",
            os.path.join(out_dir, "result.hdf5"), "--no_write_summary",
            "--no_loss", "--unseen_test"])
        out[side] = out_dir
    return out


def _h5_tree(path):
    """{id: {key: value}} of a two-level HDF5 file, strings decoded."""
    tree = {}
    with h5py.File(path, "r") as f:
        for gid, grp in f.items():
            tree[gid] = {}
            for key, ds in grp.items():
                v = ds[()]
                tree[gid][key] = v.decode() if isinstance(v, bytes) else v
    return tree


def _assert_same_h5(path_t, path_j):
    tree_t, tree_j = _h5_tree(path_t), _h5_tree(path_j)
    assert list(tree_t) == list(tree_j) and tree_j
    for gid, want in tree_j.items():
        got = tree_t[gid]
        assert set(got) == set(want), gid
        for key, v in want.items():
            if isinstance(v, str):
                assert got[key] == v, (gid, key)
            else:
                assert np.asarray(got[key]).dtype == np.asarray(v).dtype, (
                    gid, key)
                np.testing.assert_array_equal(got[key], v,
                                              err_msg=f"{gid}/{key}")


def test_text_dump_is_equal_line_for_line(dumps):
    name = f"out_{STEP}_test.txt"
    lines_t, lines_j = (open(os.path.join(dumps[s], name)).read().split("\n")
                        for s in ("torch", "jax"))
    assert lines_t == lines_j
    assert len(lines_j) == 4 * 8 + 1 and lines_j[0].startswith("[id: ")


@pytest.mark.parametrize("name", [f"out_{STEP}_test.hdf5", "result.hdf5"])
def test_hdf5_dumps_are_equal_key_for_key(dumps, name):
    _assert_same_h5(os.path.join(dumps["torch"], name),
                    os.path.join(dumps["jax"], name))


def test_log_dump_holds_every_batch_and_the_final_report(dumps):
    """out_*.log: one `[val   step N]` line a batch, then the Final Avg
    Report with the same accuracy lines as JAX's. The times and the
    checkpoint paths differ, and `canonical_fallback_rate` is left out:
    JAX's counters run on through the whole process (other tests of the
    same worker feed them), the port's are per run."""
    def body(side):
        text = open(os.path.join(dumps[side],
                                 f"out_{STEP}_test.log")).read()
        assert len(re.findall(r"^\[val   step", text, re.M)) == 2
        final = text[text.index("[Final Avg Report]"):]
        final = final.replace("[Acc]  canonical_fallback_rate", "[Acc]  x")
        lines = [ln for ln in final.split("\n") if not ln.startswith(
            ("[Time]", "Checkpoint:", "canonical_fallback_rate",
             "[Acc]  x"))]
        # the first accuracy line carries the "[Acc]  " prefix
        return [ln.replace("[Acc]  ", "") for ln in lines]
    assert body("torch") == body("jax")


def test_cli_takes_every_flag_of_the_jax_cli():
    """One argv runs in both CLIs: every option string in the JAX
    evaler_cli.py and flags.py is an option of the port's parser."""
    import demo2program_tpu.cli.flags as jax_flags
    options = set()
    for module in (jax_cli, jax_flags):
        source = open(module.__file__).read()
        options |= set(re.findall(r'add_argument\(\s*"(--\w+)"', source))
    assert {"--sweep_steps", "--pred_program", "--id_list",
            "--no_loss"} <= options
    train_only = {"--train_dir", "--learning_rate", "--lr_weight_decay",
                  "--log_step", "--write_summary_step", "--test_sample_step",
                  "--ckpt_save_step", "--max_steps", "--profile_steps",
                  "--profile_start", "--sample_images"}
    have = set(evaler_cli.build_parser()._option_string_actions)
    missing = options - have - (train_only - {"--train_dir", "--max_steps"})
    assert not missing, missing


# -- the sweep -------------------------------------------------------------------

@pytest.mark.parametrize("summary", [False, True],
                         ids=["default_summary", "summary_file"])
def test_sweep_writes_one_summary_a_step_and_skips_finished(
        world, tmp_path, summary, monkeypatch):
    """--sweep_steps 7,9,11 with checkpoints 7 and 9: one Evaler is built,
    each step writes its own dump and its own summary (the default name
    holds the checkpoint's; a given --summary_file gets `.<step>`), step 11
    is skipped with a warning, and a relaunch evaluates nothing."""
    train_dir = str(tmp_path / "run")
    shutil.copytree(world["torch_dir"], train_dir)
    ckpt = os.path.join(train_dir, "ckpt")
    shutil.copy(os.path.join(ckpt, f"{STEP}.pt"),
                os.path.join(ckpt, f"{STEP + 2}.pt"))
    built = []
    init = evaler_module.Evaler.__init__

    def counting_init(self, *a, **kw):
        built.append(1)
        init(self, *a, **kw)

    monkeypatch.setattr(evaler_module.Evaler, "__init__", counting_init)
    argv = world["argv"] + [
        "--device", "cpu", "--train_dir", train_dir, "--pred_program",
        "--sweep_steps", f"{STEP},{STEP + 2},{STEP + 4}"]
    if summary:
        argv += ["--summary_file", str(tmp_path / "report.txt")]
    evaler_cli.main(argv)
    assert len(built) == 1
    mtimes = {}
    for step in (STEP, STEP + 2):
        log_path = os.path.join(train_dir, f"out_{step}_test.log")
        assert "Final Avg Report" in open(log_path).read()
        mtimes[log_path] = os.path.getmtime(log_path)
        path = (str(tmp_path / f"report.txt.{step}") if summary else
                os.path.join(ckpt, f"{step}.pt_report_testdata8_num_k3.txt"))
        text = open(path).read()
        assert f"ckpt/{step}.pt" in text and "[Final Avg Report]" in text
    assert not os.path.exists(
        os.path.join(train_dir, f"out_{STEP + 4}_test.log"))
    assert not os.path.exists(tmp_path / "report.txt")

    evaler_cli.main(argv)   # everything is finished: nothing is rebuilt
    assert len(built) == 1
    for path, mtime in mtimes.items():
        assert os.path.getmtime(path) == mtime


def test_sweep_needs_a_train_dir(world):
    with pytest.raises(SystemExit, match="train_dir"):
        evaler_cli.main(world["argv"] + ["--device", "cpu",
                                         "--sweep_steps", "7"])


# -- --id_list -------------------------------------------------------------------

@pytest.mark.parametrize("side", ["torch", "jax"])
def test_id_list_with_an_unknown_id_raises(world, tmp_path, side):
    ids = create_default_splits(world["data"], num_k=K, is_train=False)[1].ids
    listing = tmp_path / "ids.txt"
    listing.write_text("\n".join(list(ids[:3]) + ["no_such_program"]) + "\n")
    main, extra = ((evaler_cli.main, ["--device", "cpu"]) if side == "torch"
                   else (jax_cli.main, []))
    with pytest.raises(RuntimeError, match="1 invalid ids.*no_such_program"):
        main(world["argv"] + extra + ["--id_list", str(listing),
                                      "--no_write_summary"])


def test_id_list_evaluates_the_listed_ids(world, tmp_path):
    ids = create_default_splits(world["data"], num_k=K, is_train=False)[1].ids
    wanted = [ids[5], ids[2], ids[6], ids[0]]
    listing = tmp_path / "ids.txt"
    listing.write_text("\n".join(wanted) + "\n")
    out_dir = str(tmp_path / "out")
    evaler_cli.main(world["argv"] + [
        "--device", "cpu", "--train_dir", world["torch_dir"], "--id_list",
        str(listing), "--pred_program", "--output_dir", out_dir,
        "--no_write_summary"])
    text = open(os.path.join(out_dir, f"out_{STEP}_test.txt")).read()
    assert re.findall(r"^\[id: (.*)\]$", text, re.M) == wanted


# -- without h5py ----------------------------------------------------------------

@pytest.mark.parametrize("flag", ["--pred_program", "--result_data"])
def test_dumps_without_h5py_fail_loudly(world, tmp_path, monkeypatch, flag):
    """On a host without h5py (the in-memory split needs none) a dump flag
    raises before the first batch, naming h5py, and writes nothing."""
    from demo2program_tpu_torch.data.karel_memory import (
        SplitConfig, generate_split)
    split = generate_split(SplitConfig(
        num_programs=BS, seed=3, k=K, test_k=2, max_program_len=12,
        max_demo_len=6, min_demo_len=3))
    out_dir = tmp_path / "out"
    args = evaler_cli.parse_args([
        "--device", "cpu", "--dataset_path", "in-memory", *COMMON,
        "--max_steps", "1", "--output_dir", str(out_dir), flag,
        "--result_data_path", str(tmp_path / "result.hdf5")])
    evaler = evaler_module.Evaler(args, split, device="cpu")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        evaler.eval_run()
    assert not out_dir.exists() and not (tmp_path / "result.hdf5").exists()


# -- the offline tools -----------------------------------------------------------

def test_eval_execution_prints_what_the_jax_tool_prints(world, dumps,
                                                        tmp_path, capsys):
    """tools/eval_execution.py on the port's VM vs the JAX tool on one dump:
    the same four result strings, the same --log file and the same merged
    --dump file; and the re-scored verdicts equal the ones the evaler
    wrote."""
    data = os.path.join(world["data"], "data.hdf5")
    dump = os.path.join(dumps["torch"], f"out_{STEP}_test.hdf5")
    texts, merged = {}, {}
    for side, tool, extra in (("torch", eval_execution, ["--device", "cpu"]),
                              ("jax", jax_eval_execution, [])):
        merged[side] = str(tmp_path / f"{side}.hdf5")
        tool.main(["--data_hdf5", data, "--output_hdf5", dump, "--batch",
                   "8", "--log", "--output_log_path",
                   str(tmp_path / f"{side}.log"), "--dump",
                   "--new_hdf5_path", merged[side]] + extra)
        printed = capsys.readouterr().out
        texts[side] = printed[:printed.index("Dumped result file")]
        assert open(tmp_path / f"{side}.log").read().strip() \
            == texts[side].strip()
    assert texts["torch"] == texts["jax"]
    assert texts["jax"].count("#correct-of-k histogram") == 4
    _assert_same_h5(merged["torch"], merged["jax"])
    scored, rescored = _h5_tree(dump), _h5_tree(merged["torch"])
    for gid, grp in scored.items():
        for key in ("program_num_execution_correct",
                    "greedy_num_execution_correct", "program_syntax",
                    "greedy_syntax"):
            assert rescored[gid][key] == grp[key], (gid, key)


def test_inspect_output_prints_what_the_jax_tool_prints(world, dumps, capsys):
    data = os.path.join(world["data"], "data.hdf5")
    dump = os.path.join(dumps["torch"], f"out_{STEP}_test.hdf5")
    texts = {}
    for side, tool in (("torch", inspect_output), ("jax", jax_inspect)):
        tool.main(["--data_hdf5", data, "--output_hdf5", dump, "--no_input",
                   "--replay"])
        texts[side] = capsys.readouterr().out
    assert texts["torch"] == texts["jax"]
    assert texts["jax"].count("[id: ") == 8 and "gt:     DEF" in texts["jax"]


def test_tools_default_to_the_card():
    """`--device` defaults to cuda, and cuda without a card raises."""
    assert eval_execution.build_parser().parse_args(
        ["--data_hdf5", "a", "--output_hdf5", "b"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eval_execution.batch_check([], [], [np.zeros((1, 1, 8, 8, 16))],
                                       [], None)
