"""The port's streaming input path on the CPU: BatchPipeline's id stream,
fast_forward and drop_keys against the JAX BatchPipeline's; a streamed
compact batch against KarelDeviceCache's gather of the same rows; the
Trainer's streaming loop (D2P_KAREL_DEVICE_CACHE=0 /
D2P_DOOM_DEVICE_CACHE=0): bitwise exact resume on Karel and ViZDoom,
`sec_data_wait` in the metrics, `--profile_steps` writing a Chrome trace
that parses and holds the program's spans; and `--sample_images`: the
port's PNGs decode (cv2.imread) to JAX's Trainer._write_sample_images'
pixels on the same batch and evals."""

import collections
import glob
import json
import os
import sys
import types

import cv2
import numpy as np
import pytest
import torch

from demo2program_tpu.data.pipeline import BatchPipeline as JaxPipeline
from demo2program_tpu.data.vizdoom_dataset import (
    create_vizdoom_splits as jax_vizdoom_splits)
from demo2program_tpu.envs.karel import (
    KarelWorld as JaxWorld, batch_to_states as jax_batch_to_states)
from demo2program_tpu.tools.karel_render import (
    state2image as jax_state2image)
from demo2program_tpu.train.trainer import Trainer as JaxTrainer
from demo2program_tpu_torch.cli import trainer_cli, vizdoom_generator_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.data.pipeline import BatchPipeline
from demo2program_tpu_torch.data.vizdoom_dataset import create_vizdoom_splits
from demo2program_tpu_torch.eval.evaler import fetch_batch
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.device_cache import KarelDeviceCache
from demo2program_tpu_torch.train.step import to_device
from demo2program_tpu_torch.train.trainer import TRAIN_DROP, Trainer
from demo2program_tpu_torch.utils import spans
from demo2program_tpu_torch.utils.png import read_png

BS = 4
SPLIT = SplitConfig(num_programs=10, seed=11, k=3, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)


@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module")
def vizdoom_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("vizdoom")
    vizdoom_generator_cli.main([
        "--datasets_root", str(root), "--dir_name", "vz", "--num_train", "8",
        "--num_test", "4", "--num_val", "0", "--num_demo_per_program", "4",
        "--num_test_demo_per_program", "2", "--seed", "5"])
    return str(root / "vz_len8_seed5")


def _ids(batches):
    return [list(b["id"]) for b in batches]


@pytest.mark.parametrize("shuffle", [True, False])
def test_id_batches_match_jax(split, shuffle):
    """Shuffled: three epochs of the endless stream; single epoch: every
    batch until the stream ends (the ragged tail dropped)."""
    jax_pipe = JaxPipeline(split, BS, shuffle=shuffle, seed=3, compact=True)
    pipe = BatchPipeline(split, BS, "cpu", shuffle=shuffle, seed=3,
                         compact=True)
    n = 3 * (len(split.ids) // BS) if shuffle else None
    want = [next(jax_pipe) for _ in range(n)] if n else list(jax_pipe)
    got = [next(pipe) for _ in range(n)] if n else list(pipe)
    pipe.close()
    assert _ids(got) == _ids(want)
    assert len(want) == (n or len(split.ids) // BS)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key != "id":
                assert isinstance(g[key], torch.Tensor)
                np.testing.assert_array_equal(g[key].numpy(), w[key], key)


def test_fast_forward_then_next_is_the_n_plus_first(split):
    """fast_forward(n) then next == next taken n + 1 times, and == the JAX
    pipeline's fast_forward, whether or not batches are queued."""
    for pre in (0, 2):  # batches drawn (and more queued) before skipping
        for n in (1, 3, 7):
            skipped, walked, jax_pipe = (
                BatchPipeline(split, BS, "cpu", seed=1, compact=True),
                BatchPipeline(split, BS, "cpu", seed=1, compact=True),
                JaxPipeline(split, BS, seed=1, compact=True))
            for pipe in (skipped, walked, jax_pipe):
                for _ in range(pre):
                    next(pipe)
            skipped.fast_forward(n)
            jax_pipe.fast_forward(n)
            for _ in range(n):
                next(walked)
            want = list(next(walked)["id"])
            assert list(next(skipped)["id"]) == want
            assert list(next(jax_pipe)["id"]) == want
            skipped.close()
            walked.close()


def test_drop_keys_match_jax(split, vizdoom_path):
    """Karel compact and ViZDoom full-wire batches with the trainer's
    train_drop keys: the same keys and arrays as the JAX pipeline's."""
    cases = [(split, split, "karel", True)]
    train = create_vizdoom_splits(vizdoom_path, num_k=3)[0]
    jax_train = jax_vizdoom_splits(vizdoom_path, num_k=3)[0]
    cases.append((train, jax_train, "vizdoom", False))
    for ds, jax_ds, kind, compact in cases:
        drop = TRAIN_DROP[kind]
        pipe = BatchPipeline(ds, BS, "cpu", seed=2, drop_keys=drop,
                             compact=compact)
        got = next(pipe)
        pipe.close()
        want = next(JaxPipeline(jax_ds, BS, seed=2, drop_keys=drop,
                                compact=compact))
        assert set(got) == set(want), kind
        assert not set(drop) & set(got)
        assert set(drop) <= set(next(JaxPipeline(jax_ds, BS, seed=2,
                                                 compact=compact)))
        for key in want:
            if key != "id":
                assert got[key].numpy().dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key].numpy(), want[key],
                                              key)
        assert pipe.bytes_shipped == sum(
            v.nbytes for k, v in want.items() if k != "id")


def test_compact_streamed_batch_equals_device_cache_gather(split):
    cache = KarelDeviceCache(split, "cpu", BS, seed=0)
    pipe = BatchPipeline(split, BS, "cpu", seed=4,
                         drop_keys=TRAIN_DROP["karel"], compact=True)
    for _ in range(3):
        batch = next(pipe)
        rows = torch.as_tensor([split.index[i] for i in batch["id"]])
        assert set(batch) - {"id"} == set(cache.data)
        for key, v in cache.data.items():
            assert torch.equal(batch[key], v.index_select(0, rows)), key
    pipe.close()


def _args(train_dir, dataset_type, *extra):
    data = (["--dataset_path", "in-memory"] if dataset_type == "karel"
            else ["--dataset_type", "vizdoom"])
    return trainer_cli.parse_args([
        "--device", "cpu", *data, "--train_dir", str(train_dir),
        "--num_k", "3", "--batch_size", str(BS),
        "--num_lstm_cell_units", "16", "--cell_impl", "pallas",
        "--log_step", "2", "--test_sample_step", "2", "--ckpt_save_step",
        "2", "--seed", "0", *extra])


def _saved(train_dir, step):
    return checkpoint.load(checkpoint.checkpoint_path(str(train_dir), step))


def _assert_equal_states(a, b):
    assert a["step"] == b["step"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(b["optimizer"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)


@pytest.mark.parametrize("dataset_type", ["karel", "vizdoom"])
def test_streamed_resume_is_bitwise(dataset_type, split, vizdoom_path,
                                    tmp_path, monkeypatch):
    """Streamed: a 4-step run, its twin, and a run stopped at step 2 and
    resumed by a new Trainer save equal checkpoints; no device cache is
    built, and each metrics row of the train split has sec_data_wait."""
    monkeypatch.setenv("D2P_KAREL_DEVICE_CACHE", "0")
    monkeypatch.setenv("D2P_DOOM_DEVICE_CACHE", "0")
    if dataset_type == "karel":
        train = test = split
    else:
        train, test = create_vizdoom_splits(vizdoom_path, num_k=3)[:2]

    def run(name, max_steps):
        args = _args(tmp_path / name, dataset_type)
        trainer = Trainer(args, train, test, device="cpu")
        assert trainer.cache is None and trainer.pipe_train is not None
        trainer.train(max_steps=max_steps)
        return trainer

    run("a", 4)
    run("b", 4)
    run("c", 2)
    with open(tmp_path / "c" / "resume.json", "w") as f:
        json.dump({"target_step": 4}, f)
    resumed = run("c", 4)
    assert resumed._auto_resumed
    first = _saved(tmp_path / "a", 4)
    _assert_equal_states(first, _saved(tmp_path / "b", 4))
    _assert_equal_states(first, _saved(tmp_path / "c", 4))
    with open(tmp_path / "a" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train_rows = [r for r in rows if r["split"] == "train"]
    assert len(train_rows) == 2
    assert all(r["sec_data_wait"] >= 0 for r in train_rows)
    assert resumed.pipe_train._pool._shutdown  # the workers were stopped


def test_streamed_step_s_trains_on_the_streams_draw_s(split, tmp_path,
                                                     monkeypatch):
    """The streamed trainer's step s reads the JAX pipeline's draw s (the
    JAX trainer spends draw 0 on initialising its state)."""
    monkeypatch.setenv("D2P_KAREL_DEVICE_CACHE", "0")
    trainer = Trainer(_args(tmp_path, "karel"), split, split, device="cpu")
    seen = []
    step = trainer.train_step
    trainer.train_step = lambda b: seen.append(list(b["id"])) or step(b)
    trainer.train(max_steps=3)
    jax_pipe = JaxPipeline(split, BS, seed=0, compact=True)
    assert seen == [list(next(jax_pipe)["id"]) for _ in range(3)]


def test_many_workers_keep_the_stream_order(split):
    """16 worker threads, 8 batches queued and a 1 µs switch interval: the
    batches still come in the id stream's order, with their own rows, and
    fast_forward between draws skips exactly what it is asked to."""
    jax_pipe = JaxPipeline(split, 2, seed=9, compact=True)
    want = [list(next(jax_pipe)["id"]) for _ in range(60)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = BatchPipeline(split, 2, "cpu", seed=9, num_threads=16,
                             prefetch=8, compact=True)
        got, drawn = [], 0
        while drawn < 60:
            if drawn % 7 == 3:
                pipe.fast_forward(2)
                got += [None, None]
                drawn += 2
                continue
            batch = next(pipe)
            rows = [split.index[i] for i in batch["id"]]
            assert torch.equal(batch["c_wall"], torch.from_numpy(
                split.arr["c_wall"][rows]))
            got.append(list(batch["id"]))
            drawn += 1
        pipe.close()
    finally:
        sys.setswitchinterval(interval)
    assert pipe._pool._shutdown
    for g, w in zip(got, want):
        assert g is None or g == w


def test_profile_steps_writes_a_trace_that_parses(split, tmp_path,
                                                  monkeypatch):
    """--profile_steps 1 --profile_start 1: one trace file of step [1, 2)
    under <train_dir>/profile/, in both loops, holding the program's spans
    of that step as ranges (tracing on for the profiled step alone, off
    after it)."""
    for name, cache in (("cached", "1"), ("streamed", "0")):
        monkeypatch.setenv("D2P_KAREL_DEVICE_CACHE", cache)
        args = _args(tmp_path / name, "karel", "--profile_steps", "1",
                     "--profile_start", "1")
        Trainer(args, split, split, device="cpu").train(max_steps=3)
        traces = glob.glob(str(tmp_path / name / "profile" / "*.json"))
        assert [os.path.basename(p) for p in traces] == [
            "trace_steps_1-2.json"]
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
        ranges = collections.Counter(e.get("name") for e in events
                                     if e.get("name", "").startswith("d2p."))
        for span in ("d2p.train.step", "d2p.train.forward",
                     "d2p.train.backward", "d2p.train.update"):
            assert ranges[span] == 1, span
        assert ranges["d2p.lstm.step"] == ranges["d2p.lstm.backward"] > 0
        assert not spans.enabled()


def _jax_stub(train_dir, cfg):
    return types.SimpleNamespace(
        train_dir=str(train_dir),
        cfg=types.SimpleNamespace(dim_program_token=cfg.dim_program_token),
        args=types.SimpleNamespace(dataset_type="karel"))


def test_sample_images_match_jax(split, tmp_path):
    """The four PNGs of one test-sample step, from the same numpy batch and
    evals: program heat map, action map and perception map decode to JAX's
    pixels; the demo strip is JAX's state2image strip scaled to 0..255,
    where the JAX trainer writes the [0, 1] floats cast to uint8 (pixels 0
    or 1: a fault of the reference, ROADMAP section 3)."""
    args = _args(tmp_path / "port", "karel", "--sample_images")
    trainer = Trainer(args, split, split, device="cpu")
    batch = fetch_batch(split, split.ids[:BS], "karel")
    _, evals = trainer.eval_step(to_device(batch, "cpu"))
    evals = {k: v.numpy() for k, v in evals.items()}
    assert {"pred_per", "pred_action_probs"} <= set(evals)
    trainer._write_sample_images(7, batch, evals)
    JaxTrainer._write_sample_images(_jax_stub(tmp_path / "jax", trainer.cfg),
                                    7, batch, evals)
    names = sorted(os.listdir(tmp_path / "port" / "samples"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "samples")) == [
        f"step_7_{kind}.png" for kind in ("action", "demo", "per",
                                          "program")]
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / "samples" / name),
                         cv2.IMREAD_UNCHANGED)
        want = cv2.imread(str(tmp_path / "jax" / "samples" / name),
                          cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape == read_png(
            tmp_path / "port" / "samples" / name).shape, name
        if "demo" in name:
            world = JaxWorld(jax_batch_to_states(
                batch["c_wall"][0, :1], batch["c_marker"][0, :1],
                batch["c_agent"][0, :1])[0], make_error=False)
            for a in batch["c_a_raw"][0, 0][:int(batch["demo_len"][0, 0]) - 1]:
                world.state_transition(int(a))
            strip = np.concatenate([jax_state2image(s) for s in world.s_h],
                                   axis=1)
            np.testing.assert_array_equal(want, strip[:, :, ::-1].astype(
                np.uint8))
            assert want.max() <= 1
            np.testing.assert_array_equal(got, (strip * 255).astype(
                np.uint8)[:, :, ::-1])
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
