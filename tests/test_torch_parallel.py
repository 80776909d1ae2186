"""Data-parallel training of the port (parallel/mesh.py and everything that
takes a `mesh`) on the CPU over gloo, tiny config (k 3, T 6, L 12, units
64, bs 8: __graft_entry__.py:13).

A dp run at world N over a global batch must compute what the port's
single-process step computes on that batch and what the JAX step computes
over an N-device mesh (the JAX step under jit computes the function of the
whole batch: BatchNorm statistics and every masked mean over all chips'
rows). The ranks are processes started by torch.multiprocessing (spawn)
with a file:// store under tmp_path; one spawn at world 2 runs every case
and the 2-rank trainer, one at world 4 the uneven step, the ViZDoom cache
and a trainer at bs 6 whose mesh of 3 leaves rank 3 out. This module
imports no JAX at its top: the ranks import it.

Cases (the JAX dry run's 1-D regimes, MULTICHIP_r05.json): the full model
on an expanded batch whose ranks differ in program and demo length and in
pixel scale ("uneven": a per-rank mean would give another function, which
`test_uneven_batch_needs_global_reductions` shows), the compact wire, the
Karel device cache (replicated, each rank gathering its rows of the global
draw), the sharded ViZDoom device cache, and the eval step with the VM's
num_correct.

Adam turns rounding into steps: an element whose gradient is within 100
Adam eps of 0 moves by about lr either way, and the two runs then read
different parameters. The per_embed Dense bias feeds BatchNorm (gradient 0
in exact arithmetic, as in tests/test_torch_train.py), and on the tiny
ViZDoom frames some rn_pool biases see every pre-activation of one sign
(gradient ~1e-9); moved by noise, they changed other elements' step-2
gradients by up to 6% between the dp and the single-process run. So every
multi-step run resets the elements whose first gradient is that small (the
same mask in every run, taken from the single process's first gradient) to
their initial values before each step.

Tolerances: dp against the port's single process, rtol 1e-5 on every
report scalar and grad_norm (f32 sums in other orders), parameters after 3
steps within 1e-5 (elements whose gradient is within 100 Adam eps of 0 may
step either way: 2 lr a step), BN statistics after step 1 within 1e-5 (from
step 2 they read parameters that such steps moved: on the uneven batch's
5-fold states conv1's running mean moved 3e-5 by step 3); the ranks bit for
bit equal; against the JAX mesh, the first step under
tests/test_torch_train.py's bounds.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.eval.scorer import KarelScorer
from demo2program_tpu_torch.models.common import ModelConfig
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.parallel.mesh import (
    DataMesh, data_parallel_size, make_mesh, shard_batch, shard_rows)
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.device_cache import (
    DoomDeviceCache, KarelDeviceCache)
from demo2program_tpu_torch.train.step import (
    TrainState, forward_loss, make_eval_step, make_train_step, to_device)
from demo2program_tpu_torch.train.trainer import Trainer

BS, N_STEPS, LR, ADAM_EPS = 8, 3, 1e-3, 1e-8
UNITS = 64
SPLIT = SplitConfig(num_programs=BS * N_STEPS, seed=5, k=3, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)
CACHE_SEED = 7
# the tiny ViZDoom split of the doom-cache case: DOOM_ITEMS programs of 8x8x3
# random 0..3 pixels (train-mode BatchNorm on near-uniform DoomLite frames is
# ill-conditioned in f32 in both packages, tests/test_torch_vizdoom_models.py)
DOOM_ITEMS, DOOM_SEED = 10, 7
DOOM = dict(k=2, test_k=2, T=4, h=8, w=8, c=3, P=6, A=11, L=8, V=42)
TRAINER_STEPS = 4
RTOL = 1e-5


# -- inputs --------------------------------------------------------------------

def _args(*extra):
    return trainer_cli.parse_args([
        "--device", "cpu", "--num_k", str(SPLIT.k), "--batch_size", str(BS),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--learning_rate", str(LR), *extra])


def karel_cfg(split):
    return config_from_dataset(_args(), split)


def doom_cfg(dims=None):
    d = dims or DOOM
    return ModelConfig(
        model="full", dataset_type="vizdoom", batch_size=BS,
        num_lstm_cell_units=UNITS, k=d["k"], test_k=d["test_k"],
        max_demo_len=d["T"], max_program_len=d["L"], h=d["h"], w=d["w"],
        depth=d["c"], action_space=d["A"], per_dim=d["P"],
        dim_program_token=d["V"], cell_impl="pallas")


class StubDoomSplit:
    """A ViZDoom split of DOOM_ITEMS random programs of the dimensions
    `dims` (default DOOM) held as the readers' `_store` (what both
    packages' DoomDeviceCache reads), made from a seed; `dataset_path` None
    (the port's cache packs in memory) or a directory with an empty
    data.hdf5 (the JAX cache's sidecar fingerprint)."""

    name = "stub"

    def __init__(self, n=DOOM_ITEMS, seed=DOOM_SEED, dataset_path=None,
                 dims=None):
        d, r = dims or DOOM, np.random.RandomState(seed)
        self.dataset_path = dataset_path
        self.num_k = self.num_demo = d["k"]
        self.test_k = d["test_k"]
        self.max_demo_len, self.max_program_len = d["T"], d["L"]
        self.s_h_h, self.s_h_w, self.s_h_c = d["h"], d["w"], d["c"]
        self.ids = [f"doom_{i:03d}" for i in range(n)]
        self._store = {}
        for i in self.ids:
            T = r.randint(2, d["T"] + 1, d["k"])
            self._store[i] = {
                "s_h": r.randint(0, 4, (d["k"], d["T"], d["h"], d["w"],
                                        d["c"])).astype(np.uint8),
                "p_v_h": (r.rand(d["k"], d["T"], d["P"]) > 0.5).astype(
                    np.uint8),
                "a_h": r.randint(0, d["A"] - 1, (d["k"], d["T"] - 1)).astype(
                    np.int8),
                "s_h_len": T.astype(np.float32),
                "program": r.randint(0, d["V"], r.randint(3, d["L"] + 1)
                                     ).astype(np.int32),
                "test_a_h": r.randint(0, d["A"] - 1, (d["test_k"],
                                                      d["T"] - 1)).astype(
                    np.int8),
                "test_s_h_len": np.full((d["test_k"],), d["T"], np.float32)}

    def __len__(self):
        return len(self.ids)


def expanded(split, cfg, ids):
    """The expanded (full wire) numpy batch of `ids`, test_* dropped."""
    batch = expand_batch(to_device(split.get_batch_compact(ids), "cpu"), cfg)
    return {k: v.numpy() for k, v in batch.items()
            if not k.startswith("test_")}


def make_uneven(batch):
    """Rows in the second half of the batch (another rank's at world 2
    and 4) get programs of at most 4 tokens, demos of 3 states and 5 times
    the state values: their masks and BatchNorm inputs differ from the first
    half's."""
    batch = {k: v.copy() for k, v in batch.items()}
    half = slice(BS // 2, BS)
    batch["program_len"][half] = np.minimum(batch["program_len"][half], 4)
    batch["demo_len"][half] = 3
    batch["s_h"][half] *= 5.0
    return batch


def karel_batches(split, cfg):
    """The three cases' global batches (numpy): uneven expanded, compact,
    and the Karel cache's draws."""
    steps = range(N_STEPS)
    ids = [split.ids[s * BS:(s + 1) * BS] for s in steps]
    cache = KarelDeviceCache(split, "cpu", BS, CACHE_SEED)
    return {
        "uneven": [make_uneven(expanded(split, cfg, i)) for i in ids],
        "compact": [{k: v for k, v in split.get_batch_compact(i).items()
                     if k != "id" and not k.startswith("test_")}
                    for i in ids],
        "karel_cache": [{k: v.numpy() for k, v in cache.batch(s).items()}
                        for s in steps]}


# -- the port's steps ----------------------------------------------------------

def run_steps(cfg, init_sd, batch_of, mesh=None, n_steps=N_STEPS,
              frozen=None):
    """`n_steps` train steps of cfg.model from `init_sd` on
    batch_of(step) (a dict of tensors: the rank's rows under `mesh`), the
    `frozen` elements ({name: mask}) reset to init_sd's before each step ->
    per step: report, gradients, state_dict."""
    model = get_model_class(cfg.model)(cfg)
    model.load_state_dict(init_sd)
    state = TrainState(model, LR)
    step = make_train_step(state, cfg, cfg.model, mesh=mesh)
    out = []
    for s in range(n_steps):
        with torch.no_grad():
            for name, mask in (frozen or {}).items():
                model.get_parameter(name)[mask] = init_sd[name][mask]
        report = step(batch_of(s))
        out.append({
            "report": {k: float(v) for k, v in report.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "sd": {k: v.clone() for k, v in model.state_dict().items()}})
    return out


def run_eval(cfg, init_sd, batch, mesh=None):
    """The eval step (greedy) and the VM's verdicts of the greedy and the
    ground-truth programs -> report, greedy tokens and lengths, num_correct
    of each (the rank's rows under `mesh`)."""
    model = get_model_class("full")(cfg)
    model.load_state_dict(init_sd)
    report, evals = make_eval_step(model, cfg, "full", mesh=mesh)(batch)
    scorer = KarelScorer(cfg, "cpu")
    nc, _ = scorer.execution(evals["greedy_tokens"], evals["greedy_len"],
                             evals["greedy_is_same_seq"], batch["s_h"],
                             batch["demo_len"])
    gt_nc, _ = scorer.execution(batch["program_tokens"],
                                batch["program_len"][:, 0].int(),
                                torch.zeros(batch["s_h"].shape[0]),
                                batch["s_h"], batch["demo_len"])
    return {"report": {k: float(v) for k, v in report.items()},
            "evals": {k: v.numpy() for k, v in evals.items()},
            "num_correct": np.asarray(nc), "gt_num_correct": np.asarray(gt_nc)}


def _local(batch, mesh):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in shard_batch(batch, mesh).items()}


def _trainer_args(train_dir, steps, *extra):
    return _args("--train_dir", train_dir, "--max_steps", str(steps),
                 "--log_step", "1", "--test_sample_step", "2",
                 "--ckpt_save_step", "2", "--seed", "3", *extra)


def run_trainer(job, name, steps, target=None, mesh=None):
    """A Trainer of job["trainer_dir"]/<name> trained `steps` steps (with
    `target`: a relaunch of a killed stage of that target)."""
    train_dir = os.path.join(job["trainer_dir"], name)
    split = job["split"]
    trainer = Trainer(_trainer_args(train_dir, steps), split, split,
                      device="cpu")
    if target is not None:
        if trainer.writes:  # the killed run's stage target
            with open(os.path.join(train_dir, "resume.json"), "w") as f:
                json.dump({"target_step": target}, f)
        trainer.mesh.barrier()
    trainer.train(max_steps=steps)
    return trainer


# -- the ranks -----------------------------------------------------------------

def _rank_main(rank, world, init_file, job_path, out_dir):
    torch.set_num_threads(1)  # tiny shapes; the ranks share the host
    mesh = make_mesh(backend="gloo", device="cpu", rank=rank,
                     world_size=world, init_method=f"file://{init_file}")
    try:
        job = torch.load(job_path, weights_only=False)
        out = {}
        for name, case in job["cases"].items():
            cfg, sd = case["cfg"], case["init_sd"]
            frozen = case.get("frozen")
            if case["kind"] == "batches":
                out[name] = run_steps(cfg, sd, lambda s, c=case: _local(
                    c["batches"][s], mesh), mesh, frozen=frozen)
            elif case["kind"] == "karel_cache":
                cache = KarelDeviceCache(job["split"], "cpu", BS, CACHE_SEED,
                                         mesh=mesh)
                out[name] = run_steps(cfg, sd, cache.batch, mesh,
                                      frozen=frozen)
            elif case["kind"] == "doom_cache":
                cache = DoomDeviceCache(StubDoomSplit(), "cpu", BS,
                                        CACHE_SEED, mesh=mesh)
                out[name] = run_steps(cfg, sd, cache.batch, mesh,
                                      frozen=frozen)
                out[name + "_rows"] = [
                    (cache.draws(s), {k: v.numpy() for k, v in
                                      cache.batch(s).items()})
                    for s in range(N_STEPS)]
            elif case["kind"] == "eval":
                out[name] = run_eval(cfg, sd, _local(case["batch"], mesh),
                                     mesh)
        if "outside_dir" in job:  # bs 6 over 4 ranks: a mesh of 3
            trainer = Trainer(_trainer_args(job["outside_dir"], 2,
                                            "--batch_size", "6"),
                              job["split"], job["split"], device="cpu")
            trainer.train(max_steps=2)
            out["outside"] = (trainer.mesh.rank, trainer.mesh.world)
        if "trainer_dir" in job:
            run_trainer(job, "a", TRAINER_STEPS, mesh=mesh)
            run_trainer(job, "c", TRAINER_STEPS // 2, mesh=mesh)
            resumed = run_trainer(job, "c", TRAINER_STEPS,
                                  target=TRAINER_STEPS, mesh=mesh)
            out["trainer_resumed"] = resumed._auto_resumed
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(world, job, tmp, rank_main=_rank_main):
    """Start `job` on `world` gloo ranks, each running `rank_main(rank,
    world, init_file, job_path, out_dir)`, which saves its results to
    <out_dir>/rank<r>.pt -> finish(), which waits for them and returns
    each rank's results."""
    job_path = os.path.join(tmp, "job.pt")
    torch.save(job, job_path)
    ctx = mp.start_processes(
        rank_main, args=(world, os.path.join(tmp, "store"), job_path, tmp),
        nprocs=world, join=False, start_method="spawn")

    def finish():
        while not ctx.join():
            pass
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]

    return finish


# -- the JAX side (imported here, in the test process only) --------------------

def jax_init(cfg, batch, seed):
    """JAX train state of numpy-drawn variables (tests/test_torch_models.py:
    _random_variables, random BN statistics; no compile) -> (state, the
    port's state_dict)."""
    import jax
    import jax.numpy as jnp

    from demo2program_tpu.models.common import ModelConfig as JaxConfig
    from demo2program_tpu.models.registry import get_model_class as jaxcls
    from demo2program_tpu.train.step import TrainState as JaxState
    from demo2program_tpu.train.step import make_optimizer
    from demo2program_tpu_torch.models.convert import flax_to_state_dict
    from tests.test_torch_models import _random_variables

    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    variables = _random_variables(jaxcls(cfg.model)(jcfg, train=True),
                                  expand_batch_jax(batch, jcfg), seed)
    params, stats = variables["params"], variables["batch_stats"]
    state = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                     batch_stats=stats,
                     opt_state=make_optimizer(jcfg, LR).init(params))
    return state, flax_to_state_dict(jax.device_get(params),
                                     jax.device_get(stats))


def expand_batch_jax(batch, jcfg):
    from demo2program_tpu.ops.reconstruct import expand_batch as jax_expand
    return jax_expand(batch, jcfg)


def jax_mesh_step(cfg, n_dev):
    """The JAX train step of cfg.model (make_train_step: jitted over the
    sharded batch) and an n_dev-device CPU mesh."""
    from demo2program_tpu.models.common import ModelConfig as JaxConfig
    from demo2program_tpu.models.registry import get_model_class as jaxcls
    from demo2program_tpu.parallel import make_mesh as jax_mesh
    from demo2program_tpu.train.step import make_optimizer
    from demo2program_tpu.train.step import make_train_step as jax_step

    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    return (jax_step(jaxcls(cfg.model)(jcfg, train=True), jcfg,
                     make_optimizer(jcfg, LR), cfg.model, donate=False),
            jax_mesh(num_devices=n_dev))


def jax_mesh_first_step(step_and_mesh, state, batch):
    """The JAX step over its mesh on `batch` -> report and the port's
    state_dict after the step."""
    import jax

    from demo2program_tpu.parallel import replicated_sharding
    from demo2program_tpu.parallel.mesh import shard_batch as jax_shard
    from demo2program_tpu_torch.models.convert import flax_to_state_dict

    step, mesh = step_and_mesh
    state, report = step(jax.device_put(state, replicated_sharding(mesh)),
                         jax_shard(batch, mesh), jax.random.key(1))
    return {"report": {k: float(v) for k, v in
                       jax.device_get(report).items()},
            "sd": flax_to_state_dict(jax.device_get(state.params),
                                     jax.device_get(state.batch_stats))}


def gradients(cfg, init_sd, batch):
    """{parameter: the train objective's gradient on `batch` (tensors) from
    init_sd}, one process; zeros where no gradient reaches."""
    model = get_model_class(cfg.model)(cfg)
    model.load_state_dict(init_sd)
    loss, _ = forward_loss(model, cfg, batch, cfg.model)
    loss.backward()
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in model.named_parameters()}


def frozen_mask(cfg, init_sd, batch):
    """{parameter: elements whose gradient on the global `batch` from
    init_sd is within 100 Adam eps of 0}."""
    return {n: g.abs() < 100 * ADAM_EPS
            for n, g in gradients(cfg, init_sd, _local(batch, None)).items()}


# -- checks --------------------------------------------------------------------

def assert_reports_close(got, want, what, rtol=RTOL, atol=1e-7):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def assert_params_close(got, want, what):
    """Of two runs' per-step results: the BN statistics after step 1 within
    1e-5; the parameters after the last step within 1e-5, but elements
    whose gradient was within 100 Adam eps of 0 in some step, which Adam
    may step either way (2 lr a step). (From step 2 the statistics read
    parameters that such steps moved.)"""
    for name, want_v in want[0]["sd"].items():
        if "running_" in name:
            err = (got[0]["sd"][name] - want_v).abs().max().item()
            assert err <= 1e-5, (what, name, err)
    for name in got[0]["grads"]:  # the parameters
        err = (got[-1]["sd"][name] - want[-1]["sd"][name]).abs().numpy()
        tiny = np.zeros(err.shape, bool)
        for g in [x["grads"] for x in got + want if "grads" in x]:
            tiny |= g[name].abs().numpy() < 100 * ADAM_EPS
        assert err[~tiny].max(initial=0.0) <= 1e-5, (what, name)
        assert err[tiny].max(initial=0.0) <= 2 * LR * len(got), (what, name)


def assert_ranks_equal(per_rank, name):
    first = per_rank[0][name]
    for other in per_rank[1:]:
        for a, b in zip(first, other[name]):
            assert a["report"] == b["report"], name
            for k, v in a["sd"].items():
                assert torch.equal(v, b["sd"][k]), (name, k)


def assert_dp_matches_single(per_rank, single, name):
    assert_ranks_equal(per_rank, name)
    dp = per_rank[0][name]
    for s, (a, b) in enumerate(zip(dp, single)):
        assert_reports_close(a["report"], b["report"], f"{name} step {s}")
    assert_params_close(dp, single, name)


# -- fixtures ------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


@pytest.fixture(scope="module")
def world2(split, tmp_path_factory):
    """Every case: the port's 2-rank run (one spawn, started first), JAX
    on a 2-device mesh and the port in one process on the global batches
    while the ranks run, the 2-rank trainer's runs and a single-process
    trainer run."""
    from demo2program_tpu.parallel import make_mesh as jax_mesh
    from demo2program_tpu.train.device_cache import (
        DoomDeviceCache as JaxDoomCache)

    cfg, dcfg = karel_cfg(split), doom_cfg()
    batches = karel_batches(split, cfg)
    eval_batch = expanded(split, cfg, split.ids[:BS])
    djax_ds = StubDoomSplit(dataset_path=str(tmp_path_factory.mktemp("d")))
    open(os.path.join(djax_ds.dataset_path, "data.hdf5"), "w").close()
    jcache = JaxDoomCache(djax_ds, BS, seed=CACHE_SEED,
                          mesh=jax_mesh(num_devices=2))
    doom_batches, doom_ids = [], []
    for _ in range(N_STEPS):
        b = next(jcache)
        doom_ids.append(list(b.pop("id")))
        doom_batches.append({k: np.asarray(v) for k, v in b.items()})
    state, init_sd = jax_init(cfg, batches["compact"][0], seed=2)
    dstate, dinit_sd = jax_init(dcfg, doom_batches[0], seed=3)
    batches["doom_cache"] = doom_batches
    cases = {name: {"kind": kind, "cfg": dcfg if kind == "doom_cache" else cfg,
                    "init_sd": dinit_sd if kind == "doom_cache" else init_sd}
             for name, kind in (("uneven", "batches"), ("compact", "batches"),
                                ("karel_cache", "karel_cache"),
                                ("doom_cache", "doom_cache"))}
    for name, case in cases.items():
        case["frozen"] = frozen_mask(case["cfg"], case["init_sd"],
                                     batches[name][0])
        if case["kind"] == "batches":
            case["batches"] = batches[name]

    tmp = str(tmp_path_factory.mktemp("world2"))
    job = {"split": split, "trainer_dir": os.path.join(tmp, "trainer"),
           "cases": dict(cases, eval={"kind": "eval", "cfg": cfg,
                                      "init_sd": init_sd,
                                      "batch": eval_batch})}
    finish = spawn(2, job, tmp)

    res = {"cfg": cfg, "batches": batches, "doom_ids": doom_ids,
           "init_sd": init_sd, "jax": {}, "single": {},
           "trainer_dir": job["trainer_dir"]}
    steps = {cfg: jax_mesh_step(cfg, 2), dcfg: jax_mesh_step(dcfg, 2)}
    for name, case in cases.items():
        c, sd = case["cfg"], case["init_sd"]
        res["jax"][name] = jax_mesh_first_step(
            steps[c], dstate if c is dcfg else state, batches[name][0])
        res["single"][name] = run_steps(
            c, sd, lambda s, n=name: _local(batches[n][s], None),
            frozen=case["frozen"])
    res["jax_eval"] = _jax_eval(cfg, state, eval_batch, 2)
    res["single_eval"] = run_eval(cfg, init_sd, _local(eval_batch, None))
    single_dir = os.path.join(tmp, "single")
    Trainer(_trainer_args(single_dir, TRAINER_STEPS), split, split,
            device="cpu").train(max_steps=TRAINER_STEPS)
    res["single_trainer_dir"] = single_dir
    res["ranks"] = finish()
    return res


def _jax_eval(cfg, state, batch, n_dev):
    """The JAX eval step on an n_dev mesh and the JAX scorer's verdicts."""
    import jax

    from demo2program_tpu.eval.scorer import KarelScorer as JaxScorer
    from demo2program_tpu.models.common import ModelConfig as JaxConfig
    from demo2program_tpu.models.registry import get_model_class as jaxcls
    from demo2program_tpu.parallel import make_mesh as jax_mesh
    from demo2program_tpu.parallel import replicated_sharding
    from demo2program_tpu.parallel.mesh import shard_batch as jax_shard
    from demo2program_tpu.train.step import make_eval_step as jax_eval_step

    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    mesh = jax_mesh(num_devices=n_dev)
    report, evals = jax_eval_step(jaxcls("full")(jcfg, train=False), jcfg,
                                  "full")(
        jax.device_put(state, replicated_sharding(mesh)),
        jax_shard(batch, mesh))
    evals = {k: np.asarray(v) for k, v in jax.device_get(evals).items()}
    scorer = JaxScorer(jcfg)
    nc, _ = scorer.execution(evals["greedy_tokens"], evals["greedy_len"],
                             evals["greedy_is_same_seq"], batch["s_h"],
                             batch["demo_len"])
    gt_nc, _ = scorer.execution(
        batch["program_tokens"], batch["program_len"][:, 0].astype(np.int32),
        np.zeros(BS, np.float32), batch["s_h"], batch["demo_len"])
    return {"report": {k: float(v) for k, v in
                       jax.device_get(report).items()},
            "evals": evals, "num_correct": np.asarray(nc),
            "gt_num_correct": np.asarray(gt_nc)}


# -- tests: world 2 -------------------------------------------------------------

CASES = ("uneven", "compact", "karel_cache", "doom_cache")


@pytest.mark.parametrize("case", CASES)
def test_dp_step_matches_single_process(world2, case):
    """Reports and grad_norm of every step within rtol 1e-5 of the port's
    single-process step on the global batches, BN statistics after step 1
    and parameters after 3 steps within 1e-5, the two ranks bit for bit
    equal."""
    assert_dp_matches_single(world2["ranks"], world2["single"][case], case)


@pytest.mark.parametrize("case", CASES)
def test_dp_step_matches_jax_mesh(world2, case):
    """The 2-rank run's first step against the JAX step jitted over a
    2-device mesh on the same global batch, under tests/test_torch_train.py's
    bounds: every report scalar at atol 1e-4, grad_norm at rtol 1e-4,
    parameters (Adam's near-zero-gradient elements: 2 lr) and BN statistics
    within 1e-5. Later steps are held against the port's single process
    only: JAX's own 2-device run leaves its 1-device run by 1.6e-4 in
    grad_norm at step 2 of the uneven batch, Adam turning rounding into
    steps."""
    dp, jx = world2["ranks"][0][case][0], world2["jax"][case]
    report = dict(dp["report"])
    np.testing.assert_allclose(report.pop("grad_norm"),
                               jx["report"]["grad_norm"], rtol=1e-4)
    assert_reports_close(report, {k: v for k, v in jx["report"].items()
                                  if k != "grad_norm"}, case, rtol=0,
                         atol=1e-4)
    assert_params_close([dp], [jx], case)


def test_uneven_batch_needs_global_reductions(world2):
    """On the uneven batch the 2-rank step's gradient is the single
    process's within 1e-5 of its norm, while a per-rank objective (each
    rank's BatchNorm statistics and masked means, the gradients averaged as
    DDP averages them) is another function: its gradient misses the global
    batch's by more than 10% of its norm (73% here)."""
    cfg, sd = world2["cfg"], world2["init_sd"]
    batch = world2["batches"]["uneven"][0]
    def flat(grads):
        return torch.cat([g.reshape(-1) for g in grads.values()])

    want = flat(gradients(cfg, sd, _local(batch, None)))
    ddp = sum(flat(gradients(cfg, sd, _local(batch, DataMesh(
        r, 2, torch.device("cpu"))))) for r in range(2)) / 2
    assert (ddp - want).norm() > 0.1 * want.norm()
    got = flat(world2["ranks"][0]["uneven"][0]["grads"])
    assert (got - want).norm() <= RTOL * want.norm()


def test_doom_cache_rows_match_jax(world2):
    """Each rank of the 2-rank sharded cache gathers its rows of the JAX
    cache's global batch, and the global rows name JAX's ids."""
    ids = StubDoomSplit().ids
    for rank, res in enumerate(world2["ranks"]):
        for s, ((local, global_), rows) in enumerate(res["doom_cache_rows"]):
            assert [ids[i] for i in np.concatenate(global_)] == \
                world2["doom_ids"][s]
            want = shard_batch(world2["batches"]["doom_cache"][s],
                               DataMesh(rank, 2, torch.device("cpu")))
            assert set(rows) == set(want)
            for k, v in rows.items():
                np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_dp_eval_matches_single_process_and_jax(world2):
    """The eval step over 2 ranks: the report is the global batch's (rtol
    1e-5 of the single process, atol 1e-4 of JAX's mesh), the greedy
    tokens and the VM's num_correct of the greedy and the ground-truth
    programs equal, rank by rank, the single process's and JAX's."""
    ranks = [r["eval"] for r in world2["ranks"]]
    single, jx = world2["single_eval"], world2["jax_eval"]
    assert ranks[0]["report"] == ranks[1]["report"]
    assert_reports_close(ranks[0]["report"], single["report"], "eval")
    assert_reports_close(ranks[0]["report"], jx["report"], "eval vs jax",
                         rtol=0, atol=1e-4)
    for key in ("num_correct", "gt_num_correct"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_array_equal(got, single[key], key)
        np.testing.assert_array_equal(got, jx[key], key)
    assert (single["gt_num_correct"] == SPLIT.k).all()
    for key in ("greedy_tokens", "greedy_len"):
        got = np.concatenate([r["evals"][key] for r in ranks])
        np.testing.assert_array_equal(got, single["evals"][key], key)
        np.testing.assert_array_equal(got, jx["evals"][key], key)


def test_dp_trainer_writes_once_and_resumes_bitwise(world2):
    """The 2-rank Trainer: rank 0 alone writes (one metrics row per log
    step and sample, one samples.txt block per test sample, the
    single-process run's decoded samples), its losses are the single
    process's within rtol 1e-5, and a run stopped at step 2 and resumed
    by new Trainers saves the uninterrupted run's checkpoint bit for
    bit."""
    base = world2["trainer_dir"]
    assert all(r["trainer_resumed"] for r in world2["ranks"])
    a, c = [checkpoint.load(checkpoint.checkpoint_path(
        os.path.join(base, n), TRAINER_STEPS)) for n in "ac"]
    assert a["step"] == c["step"] == TRAINER_STEPS
    assert set(a["model"]) == set(c["model"])
    assert all(torch.equal(v, c["model"][k]) for k, v in a["model"].items())
    sa, sc = a["optimizer"]["state"], c["optimizer"]["state"]
    assert set(sa) == set(sc) and all(
        torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sc[i][k]))
        for i in sa for k in sa[i])

    def rows(train_dir):
        with open(os.path.join(train_dir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    a, single = rows(os.path.join(base, "a")), rows(
        world2["single_trainer_dir"])
    assert [(r["split"], r["step"]) for r in a] == [
        (r["split"], r["step"]) for r in single]
    assert [r["split"] for r in a].count("train") == TRAINER_STEPS
    for x, y in zip(a, single):
        assert_reports_close(
            {k: v for k, v in x.items() if k not in ("split", "time")},
            {k: v for k, v in y.items() if k not in ("split", "time")},
            "trainer")
    with open(os.path.join(base, "a", "samples.txt")) as f:
        samples = f.read()
    with open(os.path.join(world2["single_trainer_dir"], "samples.txt")) as f:
        assert samples == f.read()
    assert samples.count("# step") == TRAINER_STEPS // 2


# -- world 4, and what needs no spawn --------------------------------------------

def _init_sd(cfg, seed):
    from demo2program_tpu_torch.models.ops import init_parameters
    model = get_model_class("full")(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.state_dict()


def test_world4_uneven_step_and_doom_cache(split, tmp_path):
    """At world 4 (2 rows a rank) the uneven batch's steps and the sharded
    ViZDoom cache's steps equal the single process's on the global batches
    (the 4 ranks' rows in rank order), and every rank drew the global rows
    that one stream draws for all 4 shards. A trainer at bs 6 trains over
    a mesh of 3 (the JAX rule), and rank 3, outside it, takes no step."""
    cfg, dcfg = karel_cfg(split), doom_cfg()
    batches = karel_batches(split, cfg)["uneven"]
    init_sd, dinit_sd = _init_sd(cfg, 2), _init_sd(dcfg, 3)
    frozen = frozen_mask(cfg, init_sd, batches[0])
    outside = str(tmp_path / "outside")
    job = {"split": split, "outside_dir": outside, "cases": {
        "uneven": {"kind": "batches", "cfg": cfg, "init_sd": init_sd,
                   "batches": batches, "frozen": frozen},
        "doom_cache": {"kind": "doom_cache", "cfg": dcfg,
                       "init_sd": dinit_sd}}}
    finish = spawn(4, job, str(tmp_path))
    single = run_steps(cfg, init_sd, lambda s: _local(batches[s], None),
                       frozen=frozen)
    ranks = finish()
    assert [r["outside"] for r in ranks] == [(0, 3), (1, 3), (2, 3),
                                             (None, 3)]
    assert checkpoint.latest_checkpoint(outside) == \
        checkpoint.checkpoint_path(outside, 2)
    assert_dp_matches_single(ranks, single, "uneven")
    doom_global = [{k: np.concatenate([r["doom_cache_rows"][s][1][k]
                                       for r in ranks])
                    for k in ranks[0]["doom_cache_rows"][s][1]}
                   for s in range(N_STEPS)]
    assert_ranks_equal(ranks, "doom_cache")
    for s in range(N_STEPS):  # one step of the single process from each
        sd = dinit_sd if s == 0 else ranks[0]["doom_cache"][s - 1]["sd"]
        one = run_steps(dcfg, sd, lambda _: _local(doom_global[s], None),
                        n_steps=1)[0]
        assert_reports_close(ranks[0]["doom_cache"][s]["report"],
                             one["report"], f"doom_cache step {s}")
    stream = DoomDeviceCache(StubDoomSplit(), "cpu", BS, CACHE_SEED,
                             mesh=DataMesh(0, 4, torch.device("cpu")))
    for s in range(N_STEPS):
        local, global_ = stream.draws(s)
        for rank, res in enumerate(ranks):
            got_local, got_global = res["doom_cache_rows"][s][0]
            assert all(np.array_equal(a, b)
                       for a, b in zip(got_global, global_))
            assert all(np.array_equal(a, b)
                       for a, b in zip(got_local, local))


@pytest.mark.parametrize("n_items,world,bs", [(10, 2, 8), (10, 4, 8),
                                              (5, 4, 4)])
def test_sharded_doom_stream_matches_jax(tmp_path, n_items, world, bs):
    """The port's sharded DoomDeviceCache against JAX's DoomDeviceCache on
    a `world`-device mesh from one seed, 5 steps: the global ids of each
    step and each rank's rows of the batch, pad rows included (10 items
    over 4 shards pad 2; 5 items leave shard 3 with none, which samples its
    pad rows)."""
    from demo2program_tpu.parallel import make_mesh as jax_mesh
    from demo2program_tpu.train.device_cache import (
        DoomDeviceCache as JaxDoomCache)

    jds = StubDoomSplit(n_items, dataset_path=str(tmp_path))
    open(os.path.join(str(tmp_path), "data.hdf5"), "w").close()
    jcache = JaxDoomCache(jds, bs, seed=11, mesh=jax_mesh(num_devices=world))
    caches = [DoomDeviceCache(StubDoomSplit(n_items), "cpu", bs, 11,
                              mesh=DataMesh(r, world, torch.device("cpu")))
              for r in range(world)]
    if n_items == 5:
        assert caches[0]._shard_counts == [2, 2, 1, 0]
    for s in range(5):
        want = next(jcache)
        for r, cache in enumerate(caches):
            _, global_ = cache.draws(s)
            assert [jds.ids[i] for i in np.concatenate(global_)] == \
                list(want["id"])
            got = cache.batch(s)
            for k, v in got.items():
                np.testing.assert_array_equal(
                    v.numpy(), shard_rows(np.asarray(want[k]), DataMesh(
                        r, world, torch.device("cpu"))), err_msg=k)


def test_device_count_rule_matches_jax(tmp_path, monkeypatch):
    """data_parallel_size against the JAX trainer's own rule, run in its
    __init__ with jax.device_count patched (bs 8 on 3 devices -> a
    2-device mesh, with its warning; the mesh call is where it stops)."""
    import types

    import jax

    from demo2program_tpu.train import trainer as jax_trainer
    from demo2program_tpu_torch.utils import log

    class Stop(Exception):
        pass

    def jax_rule(bs, world):
        def stop(num_devices):
            raise Stop(num_devices)
        warned = []
        monkeypatch.setattr(jax, "device_count", lambda: world)
        monkeypatch.setattr(jax_trainer, "make_mesh", stop)
        monkeypatch.setattr(jax_trainer.log, "warn",
                            lambda *a: warned.append(a[0] % a[1:]))
        args = types.SimpleNamespace(
            batch_size=bs, learning_rate=LR, encoder_rnn_type="lstm",
            num_lstm_cell_units=UNITS, scheduled_sampling=False, num_k=3,
            train_dir=str(tmp_path), dataset_type="karel", model="full",
            prefix="p")
        with pytest.raises(Stop) as stopped:
            jax_trainer.Trainer(args, None, None, cfg=object())
        return stopped.value.args[0], warned

    for bs, world in ((8, 3), (8, 4), (32, 3), (6, 4), (7, 2), (8, 1)):
        warned = []
        monkeypatch.setattr(log, "warn",
                            lambda *a: warned.append(a[0] % a[1:]))
        got = data_parallel_size(bs, world)
        want, want_warned = jax_rule(bs, world)
        assert (got, warned) == (want, want_warned), (bs, world)
    assert data_parallel_size(8, 3) == 2


def test_world1_without_group_is_the_identity(monkeypatch):
    """No process group and no torchrun variables: make_mesh is world 1
    without a group, and sharding is the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    batch = {"x": np.arange(8)}
    assert shard_batch(batch, mesh)["x"] is batch["x"]
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(num_devices=2, device="cpu")
