"""The eval step and the batch sources of the port on the 2-D `data x demo`
mesh (parallel/mesh.py), on the CPU over gloo: dp 2 x demo 2 (world 4),
tiny config with k 4, test_k 2, T 6, L 12, units 32, bs 8.

The eval step (train/step.py:make_eval_step) on a rank's part of the
global batch (shard_batch_2d: 4 rows and 2 of the 4 seen demos) must
compute what the port's single-process eval step computes on the global
batch, in every decode mode it takes (greedy, beam with the execution
rerank, syntax_greedy, syntax_sample), and what the JAX eval step jitted
over make_mesh_2d(2, 2) computes (greedy and syntax_greedy; syntax_sample's
draws are the port's own, held against JAX in one process by
tests/test_torch_decode.py). The per-example evals are gathered over the
data index (gather_rows(t, data_axis(mesh))). Without use_mesh around the
forward the demo poolings see a rank's 2 demos only: that step is shown to
fail.

The batch sources must hand each rank shard_batch_2d of the step's global
batch: KarelDeviceCache (replicated split), BatchPipeline (the worker cuts
rows, then demos) and DoomDeviceCache (items sharded over the 4 ranks,
drawn as JAX's cache draws, exchanged in the demo group), whose global ids
must be those of JAX's DoomDeviceCache(mesh=make_mesh_2d(2, 2)).

One spawn at world 4 runs every rank-side case; the JAX side and the
single process run while the ranks run. This module imports no JAX at its
top: the ranks import it. Tolerances: the report within rtol 1e-5 / atol
1e-6 of the single process (f32 sums in other orders) and atol 1e-4 of
JAX's; token ids, lengths and rerank picks exact; beam scores within 1e-5.
"""

import argparse
import dataclasses
import os
from contextlib import nullcontext
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.data.pipeline import BatchPipeline
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.eval.scorer import KarelScorer
from demo2program_tpu_torch.models.common import TwoPassDemoEncoder
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.parallel.mesh import (
    DataMesh, data_axis, gather_rows, make_mesh_2d, shard_batch_2d)
from demo2program_tpu_torch.train import step as step_module
from demo2program_tpu_torch.train.device_cache import (
    DoomDeviceCache, KarelDeviceCache)
from demo2program_tpu_torch.train.step import make_eval_step, to_device
from demo2program_tpu_torch.train.trainer import Trainer
from tests.test_torch_parallel import StubDoomSplit, jax_init, spawn

DP, DEMO = 2, 2
WORLD = DP * DEMO
BS, K, UNITS, LR = 8, 4, 32, 1e-3
SOURCE_STEPS, CACHE_SEED = 3, 7
SPLIT = SplitConfig(num_programs=BS * SOURCE_STEPS, seed=5, k=K, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)
DOOM4 = dict(k=K, test_k=2, T=4, h=8, w=8, c=3, P=6, A=11, L=8, V=42)
DOOM_ITEMS = 10  # 10 items over 4 shards: 2 pad rows
MODES = ("greedy", "beam", "syntax_greedy", "syntax_sample")
BEAM_WIDTH = 3
# family cases of the greedy eval: (model, config overrides)
FAMILIES = {
    "summarizer": ("summarizer", {}),
    "synthesis_maxpool": ("synthesis_baseline",
                          {"demo_aggregation": "maxpool"}),
    "induction": ("induction_baseline",
                  {"encoder_rnn_type": "bilstm",
                   "attn_type": "luong_monotonic"}),
}
INIT_SEED = 2  # of the random variables (jax_init): no greedy argmax tie
SAMPLE_BS = 4  # the trainer's sample batch: 2 rows a data index, 3 samples


# -- inputs --------------------------------------------------------------------

def eval_cfg(split, model="full", **overrides):
    args = trainer_cli.parse_args([
        "--device", "cpu", "--model", model, "--num_k", str(K),
        "--batch_size", str(BS), "--num_lstm_cell_units", str(UNITS),
        "--cell_impl", "pallas", "--learning_rate", str(LR)])
    return dataclasses.replace(config_from_dataset(args, split),
                               beam_width=BEAM_WIDTH, **overrides)


def eval_batch(split, n=BS):
    """The global eval batch: the split's first `n` items, compact, with
    the unseen demos (the induction baseline reads them)."""
    return {k: v for k, v in split.get_batch_compact(split.ids[:n]).items()
            if k != "id"}


def mesh_at(rank):
    """The mesh position of `rank` without process groups (for sharding)."""
    return DataMesh(rank, WORLD, torch.device("cpu"), demo_par=DEMO)


def local_2d(batch, mesh):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch_2d(batch, mesh).items()}


def to_numpy(batch):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in batch.items()}


# -- the eval step -----------------------------------------------------------------

def run_eval(cfg, init_sd, batch, mode, mesh=None):
    """The port's eval step of cfg.model in `mode` on `batch` (tensors: the
    rank's part under `mesh`) -> report, the per-example evals and, of the
    models with a two-pass encoder, its pooled summaries of the k demos
    (the program decoder's initial state), gathered over the data index
    (the global batch's rows on every rank)."""
    model = get_model_class(cfg.model)(cfg)
    model.load_state_dict(init_sd)
    summary = {}
    if isinstance(getattr(model, "encoder", None), TwoPassDemoEncoder):
        model.encoder.register_forward_hook(lambda m, i, out: summary.update(
            {k: out[k] for k in ("demo_h_summary", "demo_c_summary")}))
    report, evals = make_eval_step(model, cfg, cfg.model, decode_mode=mode,
                                   mesh=mesh)(batch)
    rows = data_axis(mesh)
    return {"report": {k: float(v) for k, v in report.items()},
            "evals": {k: (gather_rows(v, rows) if v.dim() else v).numpy()
                      for k, v in evals.items()},
            "summary": {k: gather_rows(v, rows).numpy()
                        for k, v in summary.items()}}


def rerank(cfg, evals, batch):
    """The evaler's execution rerank of a beam eval (eval/evaler.py:
    _apply_rerank's pick) on the global batch -> the picked beam a row."""
    order = np.argsort(-evals["beam_scores"], axis=1, kind="stable")
    bt = np.take_along_axis(evals["beam_tokens"], order[:, :, None], axis=1)
    bl = np.take_along_axis(evals["beam_lengths"].astype(np.int32), order,
                            axis=1)
    return KarelScorer(cfg, "cpu").rerank_pick(bt, bl, to_device(batch,
                                                                 "cpu"))


# -- the ranks -----------------------------------------------------------------

def _rank_main(rank, world, init_file, job_path, out_dir):
    torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    mesh = make_mesh_2d(DP, DEMO, backend="gloo", device="cpu", rank=rank,
                        world_size=world, init_method=f"file://{init_file}")
    try:
        job = torch.load(job_path, weights_only=False)
        out = {"eval": {}, "family": {}}
        local = local_2d(job["batch"], mesh)
        for mode in MODES:
            out["eval"][mode] = attempt(run_eval, job["cfg"], job["init_sd"],
                                        local, mode, mesh)
        with mock.patch.object(step_module, "use_mesh",
                               lambda model, mesh: nullcontext()):
            out["no_use_mesh"] = attempt(run_eval, job["cfg"],
                                         job["init_sd"], local, "greedy",
                                         mesh)
        for name, case in job["families"].items():
            out["family"][name] = attempt(run_eval, case["cfg"],
                                          case["init_sd"], local, "greedy",
                                          mesh)
        out["sources"] = attempt(sources, job, mesh)
        out["trainer_samples"] = attempt(trainer_samples, job, mesh)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def attempt(fn, *args):
    """fn(*args), or {"error": what it raised}: a case that raises fails
    its own tests only (every rank raises alike, so none is left waiting
    in a collective)."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 -- reported by the test
        return {"error": repr(e)}


def ok(result, what):
    assert "error" not in result, f"{what}: {result.get('error')}"
    return result


def sources(job, mesh):
    """SOURCE_STEPS batches of each 2-D batch source on this rank (numpy),
    and the Doom cache's global rows of each step."""
    split = job["split"]
    karel = KarelDeviceCache(split, "cpu", BS, CACHE_SEED, include_test=True,
                             mesh=mesh)
    pipe = BatchPipeline(split, BS, "cpu", seed=CACHE_SEED, compact=True,
                         mesh=mesh)
    doom = DoomDeviceCache(StubDoomSplit(DOOM_ITEMS, dims=DOOM4), "cpu", BS,
                           CACHE_SEED, mesh=mesh)
    out = {"karel_cache": [], "pipeline": [], "doom_cache": [],
           "doom_rows": [], "pipeline_bytes": []}
    for s in range(SOURCE_STEPS):
        out["karel_cache"].append(to_numpy(karel.batch(s)))
        before = pipe.bytes_shipped
        out["pipeline"].append(to_numpy(next(pipe)))
        out["pipeline_bytes"].append(pipe.bytes_shipped - before)
        out["doom_cache"].append(to_numpy(doom.batch(s)))
        out["doom_rows"].append(np.concatenate(doom.draws(s)[1]))
    pipe.close()
    return out


def trainer_samples(job, mesh):
    """samples.txt of the Trainer's test-sample eval over the 2-D `mesh`
    (its eval step and test stream set to the mesh's: the Trainer itself
    builds 1-D meshes only) on the global sample batch -> its text on rank
    0, else None."""
    trainer = Trainer(job["trainer_args"], job["split"], job["split"],
                      device="cpu")
    trainer.model.load_state_dict(job["init_sd"])
    trainer.mesh = mesh
    trainer.writes = mesh.rank == 0
    trainer.eval_step = make_eval_step(trainer.model, trainer.cfg, "full",
                                       mesh=mesh)
    trainer.test_stream = iter([shard_batch_2d(job["sample_batch"], mesh)])
    trainer._test_sample()
    trainer.close()
    if not trainer.writes:
        return None
    with open(trainer.samples_path) as f:
        return f.read()


# -- the JAX side (imported here, in the test process only) --------------------

def jax_2d_eval(cfg, state, batch, mode):
    """The JAX eval step of the full model in `mode` jitted over
    make_mesh_2d(DP, DEMO) on `batch` placed by its shard_batch_2d ->
    report, evals (global)."""
    import jax

    from demo2program_tpu.models.common import ModelConfig as JaxConfig
    from demo2program_tpu.models.registry import get_model_class as jaxcls
    from demo2program_tpu.parallel import replicated_sharding
    from demo2program_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
    from demo2program_tpu.parallel.mesh import shard_batch_2d as jax_shard_2d
    from demo2program_tpu.train.step import make_eval_step as jax_eval_step

    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    mesh = jax_mesh_2d(DP, DEMO)
    report, evals = jax_eval_step(jaxcls("full")(jcfg, train=False), jcfg,
                                  "full", decode_mode=mode)(
        jax.device_put(state, replicated_sharding(mesh)),
        jax_shard_2d(batch, mesh))
    return {"report": {k: float(v) for k, v in
                       jax.device_get(report).items()},
            "evals": {k: np.asarray(v) for k, v in
                      jax.device_get(evals).items()}}


def jax_doom_batches(tmp):
    """SOURCE_STEPS draws of JAX's DoomDeviceCache over make_mesh_2d(DP,
    DEMO) of the stub split -> [(ids, global batch)]."""
    from demo2program_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d
    from demo2program_tpu.train.device_cache import (
        DoomDeviceCache as JaxDoomCache)

    jds = StubDoomSplit(DOOM_ITEMS, dims=DOOM4, dataset_path=tmp)
    open(os.path.join(tmp, "data.hdf5"), "w").close()
    cache = JaxDoomCache(jds, BS, seed=CACHE_SEED,
                         mesh=jax_mesh_2d(DP, DEMO))
    out = []
    for _ in range(SOURCE_STEPS):
        b = next(cache)
        ids = list(b.pop("id"))
        out.append((ids, {k: np.asarray(v) for k, v in b.items()}))
    return out


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module")
def world4(split, tmp_path_factory):
    """Every rank-side case at dp 2 x demo 2 (one spawn, started first);
    JAX's 2-D eval steps, JAX's 2-D Doom cache, the single process's eval
    steps and the unsharded sources while the ranks run."""
    cfg = eval_cfg(split)
    batch = eval_batch(split)
    state, init_sd = jax_init(cfg, batch, seed=INIT_SEED)
    families = {}
    for name, (model, overrides) in FAMILIES.items():
        fcfg = eval_cfg(split, model, **overrides)
        families[name] = {"cfg": fcfg,
                          "init_sd": jax_init(fcfg, batch, seed=INIT_SEED)[1]}
    tmp = str(tmp_path_factory.mktemp("world4"))
    train_dir = os.path.join(tmp, "trainer")
    trainer_args = trainer_cli.parse_args([
        "--device", "cpu", "--num_k", str(K), "--batch_size", str(BS),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--train_dir", train_dir])
    sample_batch = split.get_batch_compact(split.ids[:SAMPLE_BS])
    job = {"cfg": cfg, "init_sd": init_sd, "batch": batch,
           "families": families, "split": split,
           "trainer_args": trainer_args, "sample_batch": sample_batch}
    finish = spawn(WORLD, job, tmp, rank_main=_rank_main)

    res = {"cfg": cfg, "batch": batch, "single": {}, "jax": {},
           "family": {}}
    tbatch = to_device(batch, "cpu")
    for mode in MODES:
        res["single"][mode] = run_eval(cfg, init_sd, tbatch, mode)
    for mode in ("greedy", "syntax_greedy"):
        res["jax"][mode] = jax_2d_eval(cfg, state, batch, mode)
    for name, case in families.items():
        res["family"][name] = run_eval(case["cfg"], case["init_sd"], tbatch,
                                       "greedy")
    res["jax_doom"] = jax_doom_batches(str(tmp_path_factory.mktemp("d")))
    karel = KarelDeviceCache(split, "cpu", BS, CACHE_SEED, include_test=True)
    pipe = BatchPipeline(split, BS, "cpu", seed=CACHE_SEED, compact=True)
    res["karel_cache"] = [to_numpy(karel.batch(s))
                          for s in range(SOURCE_STEPS)]
    res["pipeline"] = [to_numpy(next(pipe)) for _ in range(SOURCE_STEPS)]
    pipe.close()
    single = Trainer(argparse.Namespace(**dict(
        vars(trainer_args), train_dir=os.path.join(tmp, "single"))), split,
        split, device="cpu")
    single.model.load_state_dict(init_sd)
    single.test_stream = iter([sample_batch])
    single._test_sample()
    single.close()
    with open(single.samples_path) as f:
        res["single_samples"] = f.read()
    res["ranks"] = finish()
    return res


# -- tests: the eval step --------------------------------------------------------

def assert_reports_close(got, want, what, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


TOKEN_KEYS = {"greedy": ("greedy_tokens", "greedy_len", "pred_tokens"),
              "beam": ("greedy_tokens", "greedy_len", "beam_tokens",
                       "beam_lengths"),
              "syntax_greedy": ("greedy_tokens", "greedy_len"),
              "syntax_sample": ("greedy_tokens", "greedy_len")}


@pytest.mark.parametrize("mode", MODES)
def test_2d_eval_matches_single_process(world4, mode):
    """The eval step at dp 2 x demo 2 against the single process's on the
    global batch: the report, the evals' scalars and the encoder's pooled
    summaries of the k demos within rtol 1e-5, the decoded token ids and
    lengths exact after the gather over the data
    index (the global batch's 8 rows, in order), the beam scores within
    1e-5, and the ranks of a demo group bit for bit equal. syntax_sample
    draws the global batch's noise and keeps the rank's rows."""
    single = world4["single"][mode]
    ranks = [ok(r["eval"][mode], mode) for r in world4["ranks"]]
    for r in ranks[1:]:
        assert r["report"] == ranks[0]["report"]
        for k, v in r["evals"].items():
            np.testing.assert_array_equal(v, ranks[0]["evals"][k], err_msg=k)
    got = ranks[0]
    assert_reports_close(got["report"], single["report"], mode)
    for k, v in single["summary"].items():  # the pooled demos
        np.testing.assert_allclose(got["summary"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert set(got["evals"]) == set(single["evals"])
    for k, v in single["evals"].items():
        assert got["evals"][k].shape == v.shape, k
        if k in TOKEN_KEYS[mode]:
            np.testing.assert_array_equal(got["evals"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["evals"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_2d_beam_rerank_matches_single_process(world4):
    """Beam search (K 3) with the execution rerank: the 2-D eval's beams,
    gathered over the data index, rerank on the global batch to the single
    process's picks, row for row."""
    cfg, batch = world4["cfg"], world4["batch"]
    want = rerank(cfg, world4["single"]["beam"]["evals"], batch)
    for r in world4["ranks"]:
        got = rerank(cfg, ok(r["eval"]["beam"], "beam")["evals"], batch)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ("greedy", "syntax_greedy"))
def test_2d_eval_matches_jax_2d_eval(world4, mode):
    """The eval step at dp 2 x demo 2 against JAX's eval step jitted over
    make_mesh_2d(2, 2) on the batch its shard_batch_2d places: every report
    scalar within atol 1e-4, the greedy token ids and lengths exact."""
    got = ok(world4["ranks"][0]["eval"][mode], mode)
    want = world4["jax"][mode]
    assert_reports_close(got["report"], want["report"], f"{mode} vs jax",
                         rtol=0, atol=1e-4)
    for k in ("greedy_tokens", "greedy_len"):
        np.testing.assert_array_equal(got["evals"][k], want["evals"][k],
                                      err_msg=k)


def test_2d_eval_without_use_mesh_fails(world4):
    """The mutation: the eval forward outside use_mesh (the fault before
    the repair) pools each task over a rank's 2 demos only. The encoder's
    pooled summaries, which start the program decoder (largest element
    1.2), then miss the single process's by more than 1e-3, 100 times the
    tolerance the step as it is meets (read: 2.7e-3 and 5.7e-3). At random
    weights the demos' encodings lie close together, so the decoded
    programs and the loss barely move (the loss by 2e-6)."""
    want = world4["single"]["greedy"]["summary"]
    assert set(want) == {"demo_h_summary", "demo_c_summary"}
    for r in world4["ranks"]:
        step, mutated = (ok(r[k], k) for k in ("eval", "no_use_mesh"))
        for k, v in want.items():
            np.testing.assert_allclose(ok(step["greedy"], "greedy")[
                "summary"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
            err = np.abs(mutated["summary"][k] - v).max()
            assert err > 1e-3, (k, err)


@pytest.mark.parametrize("name", FAMILIES)
def test_2d_family_eval_matches_single_process(world4, name):
    """The greedy eval of the baselines at dp 2 x demo 2 (the summarizer's
    RN pooling and synthesis' maxpool gather the demo group's demos; the
    induction model gathers its attention memory and scores its test
    demos) against the single process: reports within rtol 1e-5, the greedy
    program ids exact."""
    single = world4["family"][name]
    got = ok(world4["ranks"][0]["family"][name], name)
    assert_reports_close(got["report"], single["report"], name)
    assert set(got["evals"]) == set(single["evals"])
    for k in ("greedy_tokens", "greedy_len"):
        if k in single["evals"]:
            np.testing.assert_array_equal(got["evals"][k],
                                          single["evals"][k], err_msg=k)


def test_trainer_samples_gather_over_the_data_index(world4):
    """The Trainer's test-sample eval over the 2-D mesh, on a batch of 4
    (2 rows a data index, 3 samples written): rank 0 writes the single
    process's samples.txt, its third sample the second data index's first
    row (a world gather would repeat the first data index's rows)."""
    got = [r["trainer_samples"] for r in world4["ranks"]]
    for g in got:
        assert not isinstance(g, dict), g
    assert got[1:] == [None] * (WORLD - 1)
    assert got[0] == world4["single_samples"]
    assert got[0].count("gt    : ") == 3


# -- tests: the batch sources (faults 3.2-3.4) -------------------------------------

def _assert_batches_equal(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if v.dtype.kind != "U":  # ids: string widths are the batch's
            assert got[k].dtype == v.dtype, (what, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


@pytest.mark.parametrize("source", ("karel_cache", "pipeline"))
def test_2d_karel_sources_yield_shard_batch_2d(world4, source):
    """KarelDeviceCache and BatchPipeline on the 2-D mesh: each rank's
    batch of each step is exactly shard_batch_2d of the unsharded source's
    global batch (its rows and, of the seen-demo keys, its 2 demos; the
    pipeline's ids too)."""
    for rank, r in enumerate(world4["ranks"]):
        got = ok(r["sources"], "sources")[source]
        for s in range(SOURCE_STEPS):
            want = shard_batch_2d(world4[source][s], mesh_at(rank))
            _assert_batches_equal(got[s], want,
                                  f"{source} rank {rank} step {s}")


def test_2d_pipeline_ships_a_demo_share(world4):
    """The pipeline cuts the demos in the worker, before the copy: a rank
    ships its batch's bytes, which for the seen demos are half its rows'."""
    for r in world4["ranks"]:
        got = ok(r["sources"], "sources")["pipeline"]
        for s, n in enumerate(r["sources"]["pipeline_bytes"]):
            assert n == sum(v.nbytes for k, v in got[s].items()
                            if k != "id")
            assert got[s]["c_wall"].shape[:2] == (BS // DP, K // DEMO)


def test_2d_doom_cache_yields_shard_batch_2d_of_jax(world4):
    """DoomDeviceCache on the 2-D mesh: the global ids of every step are
    those of JAX's DoomDeviceCache(mesh=make_mesh_2d(2, 2)) from the same
    seed (10 items over 4 shards, pad rows included), and each rank's batch
    is exactly shard_batch_2d of JAX's global batch (frames and percepts
    cut to the rank's demos)."""
    ids = StubDoomSplit(DOOM_ITEMS, dims=DOOM4).ids
    for rank, r in enumerate(world4["ranks"]):
        ok(r["sources"], "sources")
        for s, (jax_ids, jax_batch) in enumerate(world4["jax_doom"]):
            assert [ids[i] for i in r["sources"]["doom_rows"][s]] == jax_ids
            want = shard_batch_2d(jax_batch, mesh_at(rank))
            _assert_batches_equal(r["sources"]["doom_cache"][s], want,
                                  f"doom rank {rank} step {s}")
            assert want["dc_s_h"].shape[:2] == (BS // DP, K // DEMO)


def test_2d_doom_cache_refuses_what_does_not_split():
    """The 2-D Doom cache's checks: a batch that does not split over the
    world (set_batch_size too, as JAX's) and demos that do not split over
    the demo indices raise ValueError."""
    mesh = mesh_at(0)
    with pytest.raises(ValueError, match="not divisible by 4"):
        DoomDeviceCache(StubDoomSplit(DOOM_ITEMS, dims=DOOM4), "cpu", 6, 1,
                        mesh=mesh)
    cache = DoomDeviceCache(StubDoomSplit(DOOM_ITEMS, dims=DOOM4), "cpu", 8,
                            1, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible by 4"):
        cache.set_batch_size(6)
    with pytest.raises(ValueError, match="demos do not split"):
        DoomDeviceCache(StubDoomSplit(DOOM_ITEMS, dims=dict(DOOM4, k=3)),
                        "cpu", 8, 1, mesh=mesh)
