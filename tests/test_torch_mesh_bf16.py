"""bf16 compute (`--compute_dtype bfloat16`) on the port's data meshes
(parallel/mesh.py), on the CPU over gloo: the 1-D mesh at world 2 and the
2-D `data x demo` mesh at dp 2 x demo 2 (world 4), tiny config with k 4,
test_k 2, T 6, L 12, units 32, bs 8.

JAX casts to bf16 inside its one jitted step (demo2program_tpu/train/
step.py:112,223), so its bf16 step of the global batch is defined on any
mesh; the port's mesh step must compute it. Every family runs on Karel
(the full model, synthesis with avgpool and, on the 2-D mesh, maxpool, the
summarizer, and the induction baseline in the variant the JAX package
traces in bf16: state features concatenated to the memory, on the 2-D mesh
with the bilstm encoder and luong_monotonic attention), and the full model
on ViZDoom (the device cache's compact batches, random 0..3 pixels: its
frames and percepts are cut to the rank's demos on the 2-D mesh).

Two correct bf16 programs round at other points (on a mesh: BatchNorm's
and the demo mean's f32 sums in other orders, then one bf16 rounding that
may flip), so a bf16 mesh step is held to the single process's bf16 step
from the same parameters on the same global batch within chip_smoke.py's
BF16_TOL, the gate the card's mesh runs meet: loss within 5e-3, grad_norm
within rtol 5e-3, every other loss within 5e-3 and accuracy within 0.1 (a
token of the batch), each gradient leaf within 0.35 of its largest element
+ 1e-4, the whole gradient within 2% of its norm. Three steps, each from
the mesh run's parameters before it; the replicas bit for bit equal after
every step. Step 1 is held against JAX's bf16 step jitted over make_mesh(2)
/ make_mesh_2d(2, 2) under tests/test_torch_bf16.py's state bounds
(parameters within 2 lr, BN statistics within a bf16 ulp + 1e-3) and the
same report bounds, grad_norm within 2%.

demo_mean reduces bf16 as jnp.mean does (f32 sums, one cast): on bf16
demos it lands within one bf16 ulp of x.mean, where the mean summed and
all-reduced in bf16 misses by 2 ulps.

The ranks are gloo processes spawned before the JAX side compiles; this
module imports no JAX at its top (the ranks import it).
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import BF16_TOL
from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.parallel.mesh import (
    demo_mean, demo_sum, make_mesh, make_mesh_2d, shard_batch,
    shard_batch_2d)
from demo2program_tpu_torch.train.device_cache import DoomDeviceCache
from demo2program_tpu_torch.train.trainer import Trainer
from tests.test_torch_demo_mesh import jax_2d_first_step
from tests.test_torch_parallel import (
    StubDoomSplit, doom_cfg, jax_init, jax_mesh_first_step, jax_mesh_step,
    run_steps, spawn)

BS, K, UNITS, LR, N_STEPS = 8, 4, 32, 1e-3, 3
SPLIT = SplitConfig(num_programs=BS * N_STEPS, seed=5, k=K, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)
DOOM4 = dict(k=K, test_k=2, T=4, h=8, w=8, c=3, P=6, A=11, L=8, V=42)
DOOM_SEED = 9
INDUCTION = {"concat_state_feature_direct_prediction": True}
# case -> (domain, model, config overrides)
CASES_1D = {
    "full": ("karel", "full", {}),
    "synthesis": ("karel", "synthesis_baseline", {}),
    "summarizer": ("karel", "summarizer", {}),
    "induction": ("karel", "induction_baseline", INDUCTION),
    "vizdoom": ("vizdoom", "full", {}),
}
CASES_2D = dict(CASES_1D, synthesis_maxpool=(
    "karel", "synthesis_baseline", {"demo_aggregation": "maxpool"}),
    induction=("karel", "induction_baseline", dict(
        INDUCTION, encoder_rnn_type="bilstm", attn_type="luong_monotonic")))
MESHES = {"1d": (2, 1), "2d": (2, 2)}  # (dp, demo_par)
ULP = 2.0 ** -7  # one bf16 ulp, relative to the value's binade
SAMPLE_BS = 4  # the trainer's sample batch at world 2: 2 rows a rank


# -- inputs --------------------------------------------------------------------

def case_cfg(split, domain, model, overrides):
    if domain == "vizdoom":
        cfg = doom_cfg(DOOM4)
    else:
        cfg = config_from_dataset(trainer_cli.parse_args([
            "--device", "cpu", "--model", model, "--num_k", str(K),
            "--batch_size", str(BS), "--cell_impl", "pallas"]), split)
    return dataclasses.replace(cfg, num_lstm_cell_units=UNITS,
                               compute_dtype="bfloat16", **overrides)


def karel_batches(split, test):
    return [{k: v for k, v in split.get_batch_compact(
        split.ids[s * BS:(s + 1) * BS]).items()
        if k != "id" and (test or not k.startswith("test_"))}
        for s in range(N_STEPS)]


def doom_batches():
    """N_STEPS draws of an unsharded ViZDoom device cache of a stub split
    (random 0..3 pixels), compact: dc_s_h, dc_per, c_a_raw, ..."""
    cache = DoomDeviceCache(StubDoomSplit(seed=DOOM_SEED, dims=DOOM4), "cpu",
                            BS, DOOM_SEED)
    return [{k: v.numpy() for k, v in cache.batch(s).items()
             if not k.startswith("test_")} for s in range(N_STEPS)]


def local(batch, mesh):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch_2d(batch, mesh).items()}


def demo_mean_input():
    """(4 tasks, 4 demos, 32) bf16 values about 1, from a seed."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn(4, K, 32, generator=g) + 1.0).to(torch.bfloat16)


def bf16_sum_demo_mean(x, mesh):
    """The demo mean as it was: the local sum, the demo group's sum and the
    division, each rounded to bf16."""
    return demo_sum(x.sum(1), mesh) / (x.shape[1] * mesh.demo_par)


def ulps(got, want):
    """|got - want| in bf16 ulps of want's binade, worst element."""
    got, want = got.float(), want.float()
    binade = torch.exp2(torch.floor(torch.log2(want.abs())))
    return float(((got - want).abs() / (binade * ULP)).max())


# -- the ranks -----------------------------------------------------------------

def _rank_main(rank, world, init_file, job_path, out_dir):
    torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    job = torch.load(job_path, weights_only=False)
    dp, demo_par = job["mesh"]
    init = f"file://{init_file}"
    mesh = (make_mesh_2d(dp, demo_par, backend="gloo", device="cpu",
                         rank=rank, world_size=world, init_method=init)
            if demo_par > 1 else
            make_mesh(backend="gloo", device="cpu", rank=rank,
                      world_size=world, init_method=init))
    try:
        out = {}
        for name, case in job["cases"].items():
            out[name] = run_steps(
                case["cfg"], case["init_sd"],
                lambda s, c=case: local(c["batches"][s], mesh), mesh)
        if demo_par > 1:  # the rank's demos of demo_mean_input()
            per = K // demo_par
            mine = demo_mean_input()[:, mesh.demo_rank * per:
                                     (mesh.demo_rank + 1) * per]
            out["demo_mean"] = (demo_mean(mine, mesh),
                                bf16_sum_demo_mean(mine, mesh))
        if "trainer_args" in job:
            out["samples"] = trainer_samples(job, mesh.rank == 0)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def trainer_samples(job, writes):
    """samples.txt of a Trainer's test-sample eval (f32, its own mesh) on
    the global sample batch -> its text where this process writes, else
    None."""
    trainer = Trainer(job["trainer_args"], job["split"], job["split"],
                      device="cpu")
    trainer.model.load_state_dict(job["sample_sd"])
    trainer.test_stream = iter([shard_batch(job["sample_batch"],
                                            trainer.mesh)])
    trainer._test_sample()
    trainer.close()
    if not writes:
        return None
    with open(trainer.samples_path) as f:
        return f.read()


# -- the JAX side (imported here, in the test process only) --------------------

def jax_first_step(cfg, state, batch, dp, demo_par):
    """JAX's bf16 train step of cfg.model jitted over make_mesh(dp) (1-D)
    or make_mesh_2d(dp, demo_par) on `batch` -> report and the port's
    state_dict after the step."""
    if demo_par == 1:
        return jax_mesh_first_step(jax_mesh_step(cfg, dp), state, batch)
    return jax_2d_first_step(cfg, state, batch)


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


def mesh_run(name, split, tmp):
    """Every case of mesh `name` on its ranks (one spawn, started first),
    JAX's first bf16 step on its mesh while they run, then the single
    process's bf16 step from each step's parameters on its global batch."""
    dp, demo_par = MESHES[name]
    batches = {"karel": karel_batches(split, False),
               "karel_test": karel_batches(split, True),
               "vizdoom": doom_batches()}
    cases, states = {}, {}
    for seed, (case, (domain, model, overrides)) in enumerate(
            (CASES_1D if demo_par == 1 else CASES_2D).items()):
        cfg = case_cfg(split, domain, model, overrides)
        kind = ("vizdoom" if domain == "vizdoom" else "karel_test"
                if model == "induction_baseline" else "karel")
        states[case], init_sd = jax_init(cfg, batches[kind][0],
                                         seed=2 + seed)
        cases[case] = {"cfg": cfg, "init_sd": init_sd,
                       "batches": batches[kind]}
    job = {"mesh": (dp, demo_par), "cases": cases}
    if demo_par == 1:  # the trainer's samples at world 2
        args = trainer_cli.parse_args([
            "--device", "cpu", "--num_k", str(K), "--batch_size", str(BS),
            "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
            "--train_dir", os.path.join(tmp, "trainer")])
        job.update(trainer_args=args, split=split,
                   sample_batch=split.get_batch_compact(
                       split.ids[:SAMPLE_BS]),
                   sample_sd=cases["full"]["init_sd"])
    finish = spawn(dp * demo_par, job, tmp, rank_main=_rank_main)
    res = {"cases": cases, "jax": {}, "single": {}}
    for case, c in cases.items():
        res["jax"][case] = jax_first_step(c["cfg"], states[case],
                                          c["batches"][0], dp, demo_par)
    if demo_par == 1:
        single = Trainer(argparse.Namespace(**dict(
            vars(job["trainer_args"]), train_dir=os.path.join(tmp, "one"))),
            split, split, device="cpu")
        res["single_samples"] = trainer_samples(dict(
            job, trainer_args=single.args), True)
        single.close()
    res["ranks"] = finish()
    for case, c in cases.items():
        steps = res["ranks"][0][case]
        res["single"][case] = [run_steps(
            c["cfg"], c["init_sd"] if s == 0 else steps[s - 1]["sd"],
            lambda _, s=s: local(c["batches"][s], None), n_steps=1)[0]
            for s in range(N_STEPS)]
    return res


@pytest.fixture(scope="module")
def world2(split, tmp_path_factory):
    return mesh_run("1d", split, str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def world4(split, tmp_path_factory):
    return mesh_run("2d", split, str(tmp_path_factory.mktemp("world4")))


# -- tests ---------------------------------------------------------------------

MESH_CASES = ([("world2", c) for c in CASES_1D]
              + [("world4", c) for c in CASES_2D])


def assert_bf16_reports_close(got, want, what, norm_rtol):
    """BF16_TOL on a report: losses within loss_atol, accuracies within
    0.1, grad_norm within `norm_rtol`."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        if k == "grad_norm":
            assert abs(g - w) <= norm_rtol * w, (what, k, g, w)
        elif k.endswith("acc"):
            assert abs(g - w) <= 0.1, (what, k, g, w)
        else:
            assert abs(g - w) <= BF16_TOL["loss_atol"], (what, k, g, w)


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_bf16_mesh_step_matches_single_process(request, mesh, case):
    """3 bf16 steps on the mesh, each against the single process's bf16
    step from the same parameters on the same global batch, within
    BF16_TOL (module docstring); the ranks bit for bit equal after every
    step; parameters, gradients and BN statistics f32."""
    run = request.getfixturevalue(mesh)
    ranks = [r[case] for r in run["ranks"]]
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            assert a["report"] == b["report"], case
            for k, v in a["sd"].items():
                assert torch.equal(v, b["sd"][k]), (case, k)
    for s, (got, want) in enumerate(zip(ranks[0], run["single"][case])):
        what = f"{mesh} {case} step {s}"
        assert_bf16_reports_close(got["report"], want["report"], what,
                                  BF16_TOL["norm_rtol"])
        diff2 = norm2 = 0.0
        for n, g in want["grads"].items():
            assert got["grads"][n].dtype == g.dtype == torch.float32
            err = (got["grads"][n] - g).abs().max().item()
            bound = (BF16_TOL["grad_rtol"] * g.abs().max().item()
                     + BF16_TOL["grad_atol"])
            assert err <= bound, (what, n, err, bound)
            diff2 += float(((got["grads"][n] - g) ** 2).sum())
            norm2 += float((g ** 2).sum())
        assert diff2 ** 0.5 <= BF16_TOL["global_rtol"] * norm2 ** 0.5, what
        assert all(v.dtype == torch.float32 for v in got["sd"].values()
                   if v.is_floating_point()), what


@pytest.mark.parametrize("mesh,case", MESH_CASES)
def test_bf16_mesh_step_matches_jax_mesh_step(request, mesh, case):
    """The first bf16 step on the mesh against JAX's bf16 step jitted over
    the same mesh shape on the same global batch: losses within 5e-3,
    accuracies within 0.1, grad_norm within 2%; parameters within 2 lr
    (Adam's first step is about lr * sign(g), and a gradient that bf16
    rounding leaves on either side of zero moves the two sides 2 lr apart),
    BN running statistics within one bf16 ulp of the running value +
    1e-3."""
    run = request.getfixturevalue(mesh)
    got, want = run["ranks"][0][case][0], run["jax"][case]
    assert_bf16_reports_close(got["report"], want["report"],
                              f"{mesh} {case} vs jax", 0.02)
    assert set(got["sd"]) == set(want["sd"])
    for name, w in want["sd"].items():
        g = got["sd"][name]
        if not g.dtype.is_floating_point:
            continue
        err = (g - w).abs().max().item()
        bound = (ULP * max(1.0, w.abs().max().item()) + 1e-3
                 if "running_" in name else 2 * LR + 1e-6)
        assert err <= bound, (mesh, case, name, err, bound)


def test_demo_mean_reduces_bf16_in_f32(world4):
    """demo_mean of bf16 demos split over the demo group: every rank's mean
    within one bf16 ulp of x.mean(1) over all 4 demos, and replicated in
    its group; the mean summed, all-reduced and divided in bf16 misses
    x.mean(1) by more than one ulp."""
    want = demo_mean_input().mean(1)
    means = [r["demo_mean"] for r in world4["ranks"]]
    for got, bf16_sum in means:
        assert got.dtype == torch.bfloat16
        assert ulps(got, want) <= 1.0
        assert torch.equal(got, means[0][0])
        assert ulps(bf16_sum, want) > 1.0


def test_trainer_samples_at_world2_match_single_process(world2):
    """The Trainer's test-sample eval at world 2 on a batch of 4 (2 rows a
    rank, 3 samples written): the samples' programs and evals are gathered
    over the data index (on a 1-D mesh, the world), and rank 0 writes the
    single process's samples.txt."""
    got = [r["samples"] for r in world2["ranks"]]
    assert got[1] is None
    assert got[0] == world2["single_samples"]
    assert got[0].count("gt    : ") == 3
