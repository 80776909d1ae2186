"""Train and eval steps, in f32 or with bf16 compute.

Port of demo2program_tpu/train/step.py: Adam (optax `adam`: b1 0.9, b2
0.999, eps 1e-8 outside the square root) after clipping by global norm 20
(optax `clip_by_global_norm`), an optional staircase decay of the learning
rate (x0.5 every 10k updates, `--lr_weight_decay`), scheduled sampling
(`--scheduled_sampling`: the decoder feeds back its own sample with a
probability that rises linearly from 0 to 0.9 over the decay steps), and the
eval step in every program decode mode, for every model family (the
objective by model name).

`--compute_dtype bfloat16` (`compute_call`, as the JAX step's `_cast_floats`
at demo2program_tpu/train/step.py:101-118, 212-224): the batch is expanded
first; then the model runs on bf16 copies of its parameters, cast inside
the graph so that backward leaves f32 gradients on the f32 parameters, and
on the expanded batch with its float32 leaves cast to bf16. The parameters,
Adam's moments, the BN running statistics and the checkpoint stay f32; the
BN layers see the running statistics in their parameters' dtype
(models/ops.py). The model's bf16 outputs go into the objective as they are
(the JAX step's cast of `out` back to float32 moves float32 leaves only, so
it moves nothing), against the uncast batch: the f32 labels and masks
promote each loss term to f32. No torch.autocast: every op's dtype is
flax's.

The train step runs eagerly: forward in train mode (BatchNorm on batch
statistics, no greedy decoders), the full objective, backward (every LSTM
step's forward in the CUDA kernel, its backward the plain recomputation,
ops/fused_lstm.py), clip, Adam. Nothing in it copies to the host: the
report holds 0-d tensors on the model's device. Scheduled sampling's draws
in step s come from a generator seeded with a pure function of (seed, s),
so a resumed run draws what the uninterrupted one drew.

Data parallelism (`mesh`, parallel/mesh.py): a rank's batch is its rows of
the global batch (on a 2-D `data x demo` mesh, with its k / D of the seen
demos: shard_batch_2d), and the step computes what the single-process step
computes on the global batch, as the JAX step does over its data mesh:
BatchNorm and the objective reduce over the global batch, the gradients
are summed across the ranks in one flat bucket after backward (so
grad_norm, the clip and Adam are identical on every rank), the report is
summed across the ranks (every rank reports the global values), and
scheduled sampling draws the global batch's noise from step_generator and
keeps the rank's rows.
"""

import os

import numpy as np
import torch
from torch.func import functional_call

from demo2program_tpu_torch.models import objective
from demo2program_tpu_torch.models.common import COMPUTE_DTYPES
from demo2program_tpu_torch.models.decoder import gumbel, scheduled_noise
from demo2program_tpu_torch.models.ops import use_mesh
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.parallel.mesh import (
    all_reduce_gradients, global_report, shard_rows, world_of)
from demo2program_tpu_torch.utils import spans

NON_TENSOR_KEYS = ("id",)
CLIP_NORM = 20.0
DECAY_STEPS, DECAY_RATE = 10000, 0.5


def strip_non_tensor(batch):
    """Drop host-only entries (the string id column)."""
    return {k: v for k, v in batch.items() if k not in NON_TENSOR_KEYS}


def to_device(batch, device):
    """numpy/tensor batch -> dict of tensors on `device` (ids dropped)."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in strip_non_tensor(batch).items()}


def resolve_device(name):
    """torch.device(name), refusing "cuda" when no card can be used: a run
    asked for on the card never quietly runs elsewhere."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
    return device


CUBLAS_WORKSPACE = ":4096:8"


def deterministic_cuda():
    """Make the card's kernels deterministic, so a run on the card repeats
    bit for bit: torch.use_deterministic_algorithms (cuDNN's deterministic
    algorithms, deterministic scatters) and cuBLAS's fixed workspace,
    CUBLAS_WORKSPACE_CONFIG, unless the caller set one. cuBLAS reads the
    variable when its first handle is made: call this before any CUDA
    work."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)
    # the mode also fills every fresh allocation, a kernel each: nothing
    # here reads memory it has not written, and the eager VM and train
    # step allocate thousands of small tensors a batch
    torch.utils.deterministic.fill_uninitialized_memory = False


def full_precision_matmuls():
    """The card's library matmuls and convs as the references compute them:
    no TF32 for f32 operands, and bf16 GEMMs that reduce their split-K
    partial sums in f32 (cuBLAS may otherwise round each partial sum to
    bf16), as the LSTM kernel and the JAX package accumulate. The entry
    points call this beside deterministic_cuda()."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def require_deterministic_cuda():
    """Raise unless the card runs deterministically (deterministic_cuda, or
    the caller's own equal settings): exact resume depends on it. Sets
    nothing: the mode is process-wide, so the entry point chooses it."""
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if not torch.are_deterministic_algorithms_enabled() or workspace not in (
            ":4096:8", ":16:8"):
        raise RuntimeError(
            "training on the card needs deterministic kernels: call "
            "train/step.py:deterministic_cuda() before any CUDA work "
            f"(deterministic algorithms: "
            f"{torch.are_deterministic_algorithms_enabled()}, "
            f"CUBLAS_WORKSPACE_CONFIG={workspace!r})")


def learning_rate_at(learning_rate, count, lr_weight_decay=False):
    """The rate of the update that follows `count` applied updates: optax
    exponential_decay(lr, 10000, 0.5, staircase=True) or the constant."""
    if not lr_weight_decay:
        return learning_rate
    return learning_rate * DECAY_RATE ** (count // DECAY_STEPS)


def sampling_prob(cfg, step):
    """The probability that scheduled sampling feeds back the sample in
    update `step` (demo2program_tpu/train/step.py:75-80): 1 - the
    teacher-forcing probability, which falls linearly from 1.0 to 0.1 over
    scheduled_sampling_decay_steps. Computed in float32, as JAX does."""
    one = np.float32(1.0)
    frac = min(np.float32(step) / np.float32(
        cfg.scheduled_sampling_decay_steps), one)
    return float(one - (one + np.float32(0.1 - 1.0) * frac))


def step_generator(seed, step, device):
    """A generator on `device` whose draws are a pure function of (seed,
    step): the randomness of train step `step`."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


def global_norm(tensors):
    """optax.global_norm: sqrt of the sum of squares of every element."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm_(tensors, norm):
    """optax.clip_by_global_norm(20), in place: unchanged when norm < 20,
    else (t / norm) * 20. No host sync: the choice is made on the device.
    (torch's clip_grad_norm_ scales by 20 / (norm + 1e-6).)"""
    keep = norm < CLIP_NORM
    for t in tensors:
        t.copy_(torch.where(keep, t, t / norm * CLIP_NORM))


class TrainState:
    """Step count (updates applied), model (parameters and BN running
    statistics) and optimizer (Adam moments)."""

    def __init__(self, model, learning_rate, lr_weight_decay=False):
        self.step = 0
        self.model = model
        self.learning_rate = learning_rate
        self.lr_weight_decay = lr_weight_decay
        self.params = list(model.parameters())
        self.optimizer = torch.optim.Adam(
            self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def apply_gradients(self):
        """Clip the parameters' gradients by global norm 20, take one Adam
        step at the scheduled rate -> the norm before clipping. A parameter
        without a gradient gets zeros, as in the JAX gradient tree. Span
        `d2p.train.update`."""
        with spans.span("d2p.train.update"):
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in self.params]
            norm = global_norm(grads)
            clip_by_global_norm_(grads, norm)
            for group in self.optimizer.param_groups:
                group["lr"] = learning_rate_at(self.learning_rate, self.step,
                                               self.lr_weight_decay)
            self.optimizer.step()
            self.step += 1
        return norm

    def state_dict(self):
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state):
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])


def cast_floats(tree, dtype):
    """A dict of tensors with its float32 leaves cast to `dtype`; integer,
    bool, uint8 and other float leaves stay
    (demo2program_tpu/train/step.py:67-72)."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in tree.items()}


def compute_call(model, cfg, batch, **kwargs):
    """model(batch, **kwargs) in cfg.compute_dtype: as it stands in float32;
    else on copies of the parameters and of the batch's float32 leaves in
    that dtype. The copies are made inside the autograd graph, so gradients
    reach the f32 parameters in f32. The buffers (BN running statistics)
    stay the model's own f32 tensors: the BN layers read them in their
    parameters' dtype and write the f32 update back."""
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    if dtype == torch.float32:
        return model(batch, **kwargs)
    params = cast_floats(dict(model.named_parameters()), dtype)
    return functional_call(model, params, (cast_floats(batch, dtype),),
                           kwargs)


def dp_of(mesh):
    """The number of row shards of the global batch."""
    return 1 if mesh is None else mesh.dp


def forward_loss(model, cfg, batch, model_name, mesh=None, **kwargs):
    """Train-mode forward of a compact or expanded batch (dict of tensors on
    the model's device) -> (loss, report) of `model_name`'s objective, over
    the global batch of `mesh` (the rank's partial sums). `kwargs` go to
    the model (scheduled sampling's sampling_prob and noise). Span
    `d2p.train.forward`."""
    with spans.span("d2p.train.forward"):
        model.train()
        batch = expand_batch(strip_non_tensor(batch), cfg)
        with use_mesh(model, mesh):
            out = compute_call(model, cfg, batch, include_greedy=False,
                               **kwargs)
        return objective.compute_loss(cfg, out, batch, model_name, mesh)


def make_train_step(state, cfg, model_name, seed=0, mesh=None):
    """-> train_step(batch, noise=None) -> report: one update of `state`
    on the rank's rows of `mesh`'s global batch (mesh None: the batch is
    the whole batch). The report has the objective's scalars and
    `grad_norm`, the global norm of the unclipped gradients
    (demo2program_tpu/train/step.py:129), all global values. With
    cfg.scheduled_sampling the program decoder samples at
    sampling_prob(cfg, state.step), drawing `noise` (the decoder's
    (Gumbel, uniform) pair) or, without it, the global batch's draws from
    step_generator(seed, state.step). Spans: `d2p.train.step` around the
    whole step; in it `d2p.train.forward`, `d2p.train.backward` (gradients
    zeroed, backward, their all-reduce and the report's) and
    `d2p.train.update`."""

    def train_step(batch, noise=None):
        with spans.span("d2p.train.step"):
            kwargs = {}
            if cfg.scheduled_sampling:
                if noise is None:  # the global batch's draws, sharded
                    device = next(state.model.parameters()).device
                    bs, L = batch["program_tokens"].shape
                    noise = tuple(shard_rows(t, mesh, dim=1) for t in (
                        scheduled_noise(L, bs * dp_of(mesh),
                                        cfg.dim_program_token,
                                        step_generator(seed, state.step,
                                                       device), device)))
                kwargs = dict(sampling_prob=sampling_prob(cfg, state.step),
                              noise=noise)
            loss, report = forward_loss(state.model, cfg, batch, model_name,
                                        mesh, **kwargs)
            with spans.span("d2p.train.backward"):
                state.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                all_reduce_gradients(state.params, mesh)
                report = global_report(
                    {k: v.detach() for k, v in report.items()}, mesh)
            report["grad_norm"] = state.apply_gradients()
            return report

    return train_step


def make_eval_step(model, cfg, model_name, decode_mode="greedy",
                   decode_seed=123, image_tensors=False, mesh=None):
    """Eval forward: loss/acc reports + program tensors for host/VM scoring
    (none for the induction baseline), with running batch-norm statistics.
    `decode_mode` is greedy | beam | syntax_greedy | syntax_sample; the
    samples of syntax_sample come from a generator seeded with
    `decode_seed` at every call, as the JAX step draws from one fixed key
    (demo2program_tpu/train/step.py:198-233). `image_tensors` adds the
    trainer's image summaries' probabilities to the evals
    (objective.program_eval_tensors). Returns eval_step(batch) ->
    (report, evals), batch being a dict of tensors on the model's device:
    with `mesh`, the rank's part of the global batch (shard_batch_2d: its
    rows, and on a 2-D mesh its demos), and then the model's poolings over
    the k demos reach the demo group (use_mesh), the report and the evals'
    scalars are the global batch's (summed across the ranks), the
    per-example evals the rank's rows (gather them over the data index,
    gather_rows(t, data_axis(mesh))), and syntax_sample's draws the global
    batch's, sharded by rows. Span `d2p.eval.step`."""
    kwargs = {} if decode_mode == "greedy" else {"decode_mode": decode_mode}

    @torch.no_grad()
    def eval_step(batch):
        with spans.span("d2p.eval.step"):
            model.eval()
            batch = expand_batch(strip_non_tensor(batch), cfg)
            if decode_mode == "syntax_sample":
                device = next(model.parameters()).device
                generator = torch.Generator(device=device).manual_seed(
                    decode_seed)
                if world_of(mesh) > 1:  # the global batch's draws, sharded
                    rows = batch["program_tokens"].shape[0] * dp_of(mesh)
                    kwargs["decode_noise"] = shard_rows(gumbel(
                        (cfg.max_program_len, rows, cfg.dim_program_token),
                        generator, device), mesh, dim=1)
                else:
                    kwargs["generator"] = generator
            with use_mesh(model, mesh):
                out = compute_call(model, cfg, batch, **kwargs)
            _, report = objective.compute_loss(cfg, out, batch, model_name,
                                               mesh)
            report.update(objective.greedy_action_report(cfg, out, batch,
                                                         model_name, mesh))
            evals = objective.program_eval_tensors(cfg, out, batch,
                                                   image_tensors, mesh)
            scalars = {("report", k): v for k, v in report.items()}
            scalars.update({("evals", k): v for k, v in evals.items()
                            if v.dim() == 0})
            for (kind, k), v in global_report(scalars, mesh).items():
                (report if kind == "report" else evals)[k] = v
            return report, evals

    return eval_step
