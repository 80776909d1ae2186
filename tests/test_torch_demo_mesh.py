"""The 2-D `data x demo` mesh of the port (parallel/mesh.py: make_mesh_2d,
shard_batch_2d, demo_sum, all_gather_demos and the per-demo terms of the
objective) on the CPU over gloo, tiny config with k 4 (k 3 does not split
over 2 demo indices), test_k 2, T 6, L 12, units 64, bs 8.

A step at dp 2 x demo 2 (world 4: each rank 4 rows and 2 of the 4 seen
demos) must compute what the port's single-process step computes on the
global batch, and what the JAX step jitted over make_mesh_2d(2, 2) computes
on the batch that shard_batch_2d places (regimes (b) and (c) of
__graft_entry__.dryrun_multichip). One spawn at world 4 runs every case;
the JAX steps and the single-process runs take place while the ranks run.
This module imports no JAX at its top: the ranks import it.

Cases: the full model on an expanded Karel batch that is uneven along both
axes (rows of the two data indices and demos of the two demo indices differ
in length and pixel scale), the compact wire, the summarizer, synthesis
with avgpool, maxpool and concat, the induction baseline (bilstm encoder,
luong_monotonic attention: its memory gathered over the demo group) and the
ViZDoom full model on an expanded batch. Every case runs 3 steps against
the single process (the Adam-noise elements reset as in
tests/test_torch_parallel.py) and its first step against JAX's 2-D step,
under that file's tolerances; the 4 ranks stay equal bit for bit.
"""

import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.models import objective
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.parallel.mesh import (
    DataMesh, global_report, make_mesh_2d, shard_batch_2d)
from demo2program_tpu_torch.train.device_cache import DoomDeviceCache
from demo2program_tpu_torch.train.step import forward_loss
from tests.test_torch_parallel import (
    BS, LR, N_STEPS, UNITS, StubDoomSplit, assert_dp_matches_single,
    assert_params_close, assert_reports_close, doom_cfg, expanded,
    frozen_mask, jax_init, make_uneven, run_steps, spawn)

DP, DEMO = 2, 2
WORLD = DP * DEMO
K = 4
SPLIT = SplitConfig(num_programs=BS * N_STEPS, seed=5, k=K, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)
DOOM4 = dict(k=K, test_k=2, T=4, h=8, w=8, c=3, P=6, A=11, L=8, V=42)
DOOM_SEED = 9
# case -> (model, config overrides, batches)
CASES = {
    "uneven": ("full", {}, "uneven"),
    "compact": ("full", {}, "compact"),
    "summarizer": ("summarizer", {}, "compact"),
    "synthesis_avgpool": ("synthesis_baseline",
                          {"demo_aggregation": "avgpool"}, "compact"),
    "synthesis_maxpool": ("synthesis_baseline",
                          {"demo_aggregation": "maxpool"}, "compact"),
    "synthesis_concat": ("synthesis_baseline",
                         {"demo_aggregation": "concat"}, "compact"),
    "induction": ("induction_baseline",
                  {"encoder_rnn_type": "bilstm",
                   "attn_type": "luong_monotonic"}, "compact_test"),
    "vizdoom": ("full", {}, "vizdoom"),
}


# -- inputs --------------------------------------------------------------------

def karel_cfg(split, model="full", **overrides):
    args = trainer_cli.parse_args([
        "--device", "cpu", "--model", model, "--num_k", str(K),
        "--batch_size", str(BS), "--num_lstm_cell_units", str(UNITS),
        "--cell_impl", "pallas", "--learning_rate", str(LR)])
    return dataclasses.replace(config_from_dataset(args, split), **overrides)


def make_uneven_2d(batch):
    """make_uneven's rows, and the demos of the second demo index with
    demos of at most 4 states and 3 times the state values: each demo's
    mask sums and BatchNorm inputs differ between the demo shards too."""
    batch = make_uneven(batch)
    half = slice(K // 2, K)
    batch["demo_len"][:, half] = np.minimum(batch["demo_len"][:, half], 4)
    batch["s_h"][:, half] *= 3.0
    return batch


def compact(split, ids, test):
    return {k: v for k, v in split.get_batch_compact(ids).items()
            if k != "id" and (test or not k.startswith("test_"))}


def doom_batches(dcfg):
    """The expanded ViZDoom batches (random 0..3 pixels) of N_STEPS draws
    of an unsharded cache of a stub split."""
    cache = DoomDeviceCache(StubDoomSplit(seed=DOOM_SEED, dims=DOOM4), "cpu",
                            BS, DOOM_SEED)
    out = []
    for s in range(N_STEPS):
        batch = expand_batch(cache.batch(s), dcfg)
        out.append({k: v.numpy() for k, v in batch.items()
                    if not k.startswith("test_")})
    return out


def global_batches(split, dcfg):
    ids = [split.ids[s * BS:(s + 1) * BS] for s in range(N_STEPS)]
    cfg = karel_cfg(split)
    return {"uneven": [make_uneven_2d(expanded(split, cfg, i)) for i in ids],
            "compact": [compact(split, i, False) for i in ids],
            "compact_test": [compact(split, i, True) for i in ids],
            "vizdoom": doom_batches(dcfg)}


def local_2d(batch, mesh):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch_2d(batch, mesh).items()}


def mesh_at(rank):
    """The mesh position of `rank` without process groups (for sharding)."""
    return DataMesh(rank, WORLD, torch.device("cpu"), demo_par=DEMO)


# -- the ranks -----------------------------------------------------------------

def _rank_main(rank, world, init_file, job_path, out_dir):
    torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    mesh = make_mesh_2d(DP, DEMO, backend="gloo", device="cpu", rank=rank,
                        world_size=world, init_method=f"file://{init_file}")
    try:
        job = torch.load(job_path, weights_only=False)
        out = {"mesh": (mesh.data_rank, mesh.demo_rank, mesh.dp,
                        mesh.demo_par)}
        try:  # a mesh that is not the world's size
            make_mesh_2d(DP, DEMO + 1, device="cpu")
        except ValueError as e:
            out["wrong_size"] = str(e)
        for name, case in job["cases"].items():
            out[name] = run_steps(
                case["cfg"], case["init_sd"],
                lambda s, c=case: local_2d(c["batches"][s], mesh), mesh,
                frozen=case["frozen"])
        trap = job["cases"]["uneven"]
        out["trap"] = trap_losses(trap["cfg"], trap["init_sd"],
                                  local_2d(trap["batches"][0], mesh), mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def trap_losses(cfg, init_sd, batch, mesh):
    """The global loss of the full model's objective as it is, and with the
    seen demos' per-demo denominators summed over the world instead of the
    data axis (data_axis patched to the whole mesh)."""
    model = get_model_class(cfg.model)(cfg)
    model.load_state_dict(init_sd)
    out = {}
    for name, axis in (("data_axis", objective.data_axis),
                       ("world", lambda m: m)):
        with mock.patch.object(objective, "data_axis", axis):
            _, report = forward_loss(model, cfg, batch, cfg.model, mesh)
        out[name] = float(global_report(report, mesh)["loss"])
    return out


# -- the JAX side (imported here, in the test process only) --------------------

def jax_2d_first_step(cfg, state, batch):
    """The JAX train step of cfg.model jitted over make_mesh_2d(DP, DEMO)
    on `batch` placed by shard_batch_2d -> report and the port's state_dict
    after the step."""
    import jax

    from demo2program_tpu.models.common import ModelConfig as JaxConfig
    from demo2program_tpu.models.registry import get_model_class as jaxcls
    from demo2program_tpu.parallel import replicated_sharding
    from demo2program_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
    from demo2program_tpu.parallel.mesh import shard_batch_2d as jax_shard_2d
    from demo2program_tpu.train.step import make_optimizer, make_train_step
    from demo2program_tpu_torch.models.convert import flax_to_state_dict

    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    step = make_train_step(jaxcls(cfg.model)(jcfg, train=True), jcfg,
                           make_optimizer(jcfg, LR), cfg.model, donate=False)
    mesh = jax_mesh_2d(DP, DEMO)
    state, report = step(jax.device_put(state, replicated_sharding(mesh)),
                         jax_shard_2d(batch, mesh), jax.random.key(1))
    return {"report": {k: float(v) for k, v in
                       jax.device_get(report).items()},
            "sd": flax_to_state_dict(jax.device_get(state.params),
                                     jax.device_get(state.batch_stats))}


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module")
def world4(split, tmp_path_factory):
    """Every case: the port at dp 2 x demo 2 (one spawn, started first),
    then JAX's 2-D step and the port's single process on the global
    batches while the ranks run."""
    dcfg = doom_cfg(DOOM4)
    batches = global_batches(split, dcfg)
    cases, states = {}, {}
    for seed, (name, (model, overrides, kind)) in enumerate(CASES.items()):
        cfg = (dcfg if kind == "vizdoom"
               else karel_cfg(split, model, **overrides))
        state, init_sd = jax_init(cfg, batches[kind][0], seed=2 + seed)
        states[name] = state
        cases[name] = {"cfg": cfg, "init_sd": init_sd,
                       "batches": batches[kind],
                       "frozen": frozen_mask(cfg, init_sd, batches[kind][0])}
    tmp = str(tmp_path_factory.mktemp("world4"))
    finish = spawn(WORLD, {"cases": cases}, tmp, rank_main=_rank_main)
    res = {"cases": cases, "jax": {}, "single": {}}
    for name, case in cases.items():
        res["jax"][name] = jax_2d_first_step(case["cfg"], states[name],
                                             case["batches"][0])
        res["single"][name] = run_steps(
            case["cfg"], case["init_sd"],
            lambda s, c=case: local_2d(c["batches"][s], None),
            frozen=case["frozen"])
    res["ranks"] = finish()
    return res


# -- tests ---------------------------------------------------------------------

def test_rank_layout_follows_jax_reshape(world4):
    """Rank r is data index r // 2 and demo index r % 2 (JAX reshapes the
    devices to (dp, demo)); a mesh whose dp x demo_par is not the world's
    size raises."""
    assert [r["mesh"] for r in world4["ranks"]] == [
        (r // DEMO, r % DEMO, DP, DEMO) for r in range(WORLD)]
    assert all("2 x 3 mesh asked for in a world of 4" in r.get(
        "wrong_size", "") for r in world4["ranks"])


@pytest.mark.parametrize("case", CASES)
def test_demo_mesh_step_matches_single_process(world4, case):
    """3 steps at dp 2 x demo 2 against the port's single process on the
    global batches: reports and grad_norm within rtol 1e-5, BN statistics
    after step 1 and parameters after step 3 within 1e-5, the 4 ranks bit
    for bit equal after every step."""
    assert_dp_matches_single(world4["ranks"], world4["single"][case], case)


@pytest.mark.parametrize("case", CASES)
def test_demo_mesh_step_matches_jax_2d_step(world4, case):
    """The first step at dp 2 x demo 2 against the JAX step jitted over
    make_mesh_2d(2, 2) on the batch shard_batch_2d places: every report
    scalar at atol 1e-4, grad_norm at rtol 1e-4, parameters and BN
    statistics within 1e-5 (Adam's near-zero-gradient elements: 2 lr)."""
    dp, jx = world4["ranks"][0][case][0], world4["jax"][case]
    report = dict(dp["report"])
    np.testing.assert_allclose(report.pop("grad_norm"),
                               jx["report"]["grad_norm"], rtol=1e-4)
    assert_reports_close(report, {k: v for k, v in jx["report"].items()
                                  if k != "grad_norm"}, case, rtol=0,
                         atol=1e-4)
    assert_params_close([dp], [jx], case)


def test_per_demo_terms_reduce_over_the_data_axis(world4):
    """The per-demo trap: each seen demo's action and perception losses are
    normalised by that demo's mask sum over the global batch, which on a
    2-D mesh lives on the data axis. Summed over the world, the
    denominators would add the mask sums of other demos: on the uneven
    batch that loss misses the single process's by more than 10%, while
    the objective as it is matches it within rtol 1e-5."""
    want = world4["single"]["uneven"][0]["report"]["loss"]
    for r in world4["ranks"]:
        got = r["trap"]
        np.testing.assert_allclose(got["data_axis"], want, rtol=1e-5)
        assert abs(got["world"] - want) > 0.1 * abs(want)


@pytest.mark.parametrize("kind", ("uneven", "compact_test", "vizdoom"))
def test_shard_batch_2d_matches_jax_shards(split, kind):
    """Each rank's arrays from shard_batch_2d equal, exactly, the shard
    that JAX's shard_batch_2d places on the device at the same mesh
    position, for every key (the seen-demo keys on both axes, the rest on
    the data axis)."""
    import jax

    from demo2program_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
    from demo2program_tpu.parallel.mesh import shard_batch_2d as jax_shard_2d

    batch = global_batches(split, doom_cfg(DOOM4))[kind][0]
    mesh = jax_mesh_2d(DP, DEMO)
    placed = jax_shard_2d(batch, mesh)
    for rank in range(WORLD):
        device = mesh.devices[rank // DEMO, rank % DEMO]
        got = shard_batch_2d(batch, mesh_at(rank))
        assert set(got) == set(placed)
        for k, v in got.items():
            want = next(s.data for s in placed[k].addressable_shards
                        if s.device == device)
            np.testing.assert_array_equal(v, jax.device_get(want),
                                          err_msg=f"{kind} {k} rank {rank}")


def test_demos_that_do_not_split_raise_on_both_sides():
    """k 3 over 2 demo indices: JAX's shard_batch_2d and the port's raise
    ValueError (and so do rows that do not split over dp)."""
    from demo2program_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
    from demo2program_tpu.parallel.mesh import shard_batch_2d as jax_shard_2d

    batch = {"s_h": np.zeros((4, 3, 2), np.float32),
             "program_len": np.ones((4, 1), np.float32)}
    with pytest.raises(ValueError):
        jax_shard_2d(batch, jax_mesh_2d(DP, DEMO))
    with pytest.raises(ValueError, match="demos"):
        shard_batch_2d(batch, mesh_at(1))
    with pytest.raises(ValueError, match="rows"):
        shard_batch_2d({"program_len": np.ones((3, 1))}, mesh_at(1))


def test_mesh_without_a_group(monkeypatch):
    """Without a process group make_mesh_2d is world 1 at 1 x 1 (every call
    the identity) and refuses a larger mesh."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    mesh = make_mesh_2d(1, 1, device="cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.demo_par) == (0, 1, None,
                                                                  1)
    batch = {"s_h": np.zeros((4, 3))}
    assert shard_batch_2d(batch, mesh)["s_h"] is batch["s_h"]
    with pytest.raises(ValueError, match="no process group"):
        make_mesh_2d(2, 2, device="cpu")
