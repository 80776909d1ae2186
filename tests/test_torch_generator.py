"""The port's Karel generator, its CLI, the shard merge and the dataset
viewer against the JAX package's, on the CPU: for one seed each backend of
the port's generator CLI writes the data.hdf5 and id.txt of the JAX CLI's
same backend (every group, dataset, dtype and data_info entry); the
in-memory split of data/karel_memory.py is the JAX generator's dataset,
and the native backend's records, in the compact form; merging two ViZDoom
shards of the port's generator CLI equals the JAX merge (up to the
`sprite_style` the JAX merge drops), and two Karel shards (which the JAX
merge cannot read) merge into a dataset the port's reader serves; the
`--no_input` text of visualize_data equals JAX's."""

import dataclasses
import os

import h5py
import numpy as np
import pytest

from demo2program_tpu import native as jax_native
from demo2program_tpu.cli import generator_cli as jax_generator_cli
from demo2program_tpu.data import karel_generator as jax_kg
from demo2program_tpu.data import merge_datasets as jax_merge
from demo2program_tpu.tools import visualize_data as jax_visualize
from demo2program_tpu_torch.cli import generator_cli, vizdoom_generator_cli
from demo2program_tpu_torch.data import merge_datasets
from demo2program_tpu_torch.data.dataset import create_default_splits
from demo2program_tpu_torch.data.karel_generator import generate_records
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split, split_from_records)
from demo2program_tpu_torch.tools import visualize_data

KAREL_FLAGS = ["--num_train", "4", "--num_test", "2", "--num_val", "2",
               "--num_demo_per_program", "3",
               "--num_test_demo_per_program", "2", "--min_demo_length", "4",
               "--max_demo_length", "12"]


def h5_contents(path):
    """{name: (dtype, value)} of every dataset in an HDF5 file, and the
    sorted group names."""
    out, groups = {}, []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj.dtype, obj[()])
        else:
            groups.append(name)

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out, sorted(groups)


def assert_same_h5(got_path, want_path, skip=()):
    got, got_groups = h5_contents(got_path)
    want, want_groups = h5_contents(want_path)
    assert got_groups == want_groups
    assert set(got) - set(skip) == set(want) - set(skip)
    for name in set(want) - set(skip):
        (dt_g, v_g), (dt_w, v_w) = got[name], want[name]
        assert dt_g == dt_w, (name, dt_g, dt_w)
        assert np.array_equal(np.asarray(v_g), np.asarray(v_w)), name


def _karel_dataset(cli, root, name, seed, backend):
    cli.main(["--datasets_root", str(root), "--dir_name", name,
              "--seed", str(seed), "--backend", backend, *KAREL_FLAGS])
    return os.path.join(root, name)


@pytest.mark.parametrize("backend", ["python", "native"])
def test_generator_cli_matches_jax(backend, tmp_path):
    if backend == "native" and not jax_native.available():
        pytest.skip("no C++ toolchain for the engine")
    want = _karel_dataset(jax_generator_cli, tmp_path / "jax", "d", 99,
                          backend)
    got = _karel_dataset(generator_cli, tmp_path / "port", "d", 99, backend)
    with open(os.path.join(want, "id.txt")) as fw, \
            open(os.path.join(got, "id.txt")) as fg:
        ids = fw.read()
        assert fg.read() == ids
    assert len(ids.split()) == 8
    assert_same_h5(os.path.join(got, "data.hdf5"),
                   os.path.join(want, "data.hdf5"))
    _, test, _ = create_default_splits(got, num_k=3)
    assert test.dsl_type == "prob" and len(test.ids) == 2


def _assert_same_split(got, want):
    assert got.ids == want.ids
    assert set(got.arr) == set(want.arr)
    for key, v in want.arr.items():
        assert got.arr[key].dtype == v.dtype, key
        np.testing.assert_array_equal(got.arr[key], v, err_msg=key)


def test_records_compact_form_is_the_in_memory_split(tmp_path):
    """data/karel_memory.py's split is the JAX generator's dataset for the
    same settings in the compact form, and so are the native backend's
    records (what the card's smoke run checks)."""
    cfg = SplitConfig(num_programs=6, seed=5, k=3, test_k=2,
                      max_program_len=20, max_demo_len=10, min_demo_len=4)
    gen = cfg.generator_config()
    want = generate_split(cfg)
    jax_kg.generate(jax_kg.GeneratorConfig(
        **{**dataclasses.asdict(gen), "dir_name": str(tmp_path)}),
        progress_every=0, backend="python")
    with open(tmp_path / "id.txt") as f:
        ids = f.read().split()
    with h5py.File(tmp_path / "data.hdf5", "r") as f:
        written = [(i, {k: v[()] for k, v in f[i].items()}) for i in ids]
    _assert_same_split(split_from_records(written, cfg.max_program_len,
                                          cfg.max_demo_len), want)
    records = list(generate_records(gen, "native", progress_every=0))
    assert records[-1][0] == "data_info"
    _assert_same_split(split_from_records(records, cfg.max_program_len,
                                          cfg.max_demo_len), want)


def test_merge_vizdoom_shards_matches_jax(tmp_path):
    shards = []
    for seed in (3, 4):
        vizdoom_generator_cli.main([
            "--datasets_root", str(tmp_path), "--dir_name", "vz",
            "--num_train", "2", "--num_test", "1", "--num_val", "0",
            "--num_demo_per_program", "3", "--num_test_demo_per_program",
            "2", "--seed", str(seed)])
        shards.append(str(tmp_path / f"vz_len8_seed{seed}"))
    jax_merge.main([*shards, "--out_dir", str(tmp_path / "jax")])
    merge_datasets.main([*shards, "--out_dir", str(tmp_path / "port")])
    with open(tmp_path / "jax" / "id.txt") as fw, \
            open(tmp_path / "port" / "id.txt") as fg:
        ids = fw.read()
        assert fg.read() == ids
    assert ids.split()[0].startswith("0_") and len(ids.split()) == 6
    # the JAX merge drops sprite_style; the port keeps it
    assert_same_h5(str(tmp_path / "port" / "data.hdf5"),
                   str(tmp_path / "jax" / "data.hdf5"),
                   skip=("data_info/sprite_style",))
    got, _ = h5_contents(str(tmp_path / "port" / "data.hdf5"))
    want, _ = h5_contents(str(tmp_path / "jax" / "data.hdf5"))
    assert "data_info/sprite_style" not in want
    assert got["data_info/sprite_style"][1] == b"v2"
    assert got["data_info/num_train"][1] == 4


def test_merge_karel_shards(tmp_path):
    """The JAX merge reads ViZDoom's s_h_h from every shard and raises on
    Karel shards; the port's merges them: every group copied under its
    shard-prefixed id, split sizes summed, maxima taken, dsl_type kept, and
    the port's reader serves the result."""
    shards = [_karel_dataset(generator_cli, tmp_path, f"k{seed}", seed,
                             "python") for seed in (1, 2)]
    with pytest.raises(KeyError):
        jax_merge.merge(shards, str(tmp_path / "jax"))
    out = str(tmp_path / "merged")
    merge_datasets.merge(shards, out)
    merged, _ = h5_contents(os.path.join(out, "data.hdf5"))
    infos = []
    n = 0
    for i, shard in enumerate(shards):
        contents, _ = h5_contents(os.path.join(shard, "data.hdf5"))
        infos.append({k.split("/")[1]: v for k, (_, v) in contents.items()
                      if k.startswith("data_info/")})
        for name, (dtype, value) in contents.items():
            if name.startswith("data_info/"):
                continue
            n += name.endswith("/program")
            got_dtype, got = merged[f"{i}_{name}"]
            assert got_dtype == dtype and np.array_equal(got, value), name
    info = {k.split("/")[1]: v for k, (_, v) in merged.items()
            if k.startswith("data_info/")}
    assert n == 16 and info["num_train"] == 8 and info["dsl_type"] == b"prob"
    for key in ("max_demo_length", "max_program_length"):
        assert info[key] == max(i[key] for i in infos), key
    train, test, val = create_default_splits(out, num_k=3)
    assert (len(train.ids), len(test.ids), len(val.ids)) == (8, 4, 4)
    batch = train.get_batch_compact(train.ids[:4])
    assert batch["c_wall"].shape[:2] == (4, 3)


def test_merge_refuses_shards_that_disagree(tmp_path):
    shards = [_karel_dataset(generator_cli, tmp_path, "k", 1, "python")]
    vizdoom_generator_cli.main([
        "--datasets_root", str(tmp_path), "--dir_name", "vz",
        "--num_train", "1", "--num_test", "0", "--num_val", "0",
        "--num_demo_per_program", "2", "--num_test_demo_per_program", "1"])
    shards.append(str(tmp_path / "vz_len8_seed123"))
    with pytest.raises(ValueError, match="data_info keys"):
        merge_datasets.merge(shards, str(tmp_path / "out"))


def test_visualize_no_input_matches_jax(tmp_path, capsys):
    path = _karel_dataset(generator_cli, tmp_path, "d", 7, "python")
    outputs = []
    for module in (jax_visualize, visualize_data):
        for extra in ([], ["--max_demos", "1"]):
            module.main(["--dataset_path", path, "--no_input", *extra])
            outputs.append(capsys.readouterr().out)
    assert outputs[:2] == outputs[2:]
    assert "program: DEF run m(" in outputs[0]
    assert outputs[0].count("-- demo") == 3
