"""Data parallelism across processes, with the JAX step's global-batch
semantics.

Port of demo2program_tpu/parallel/mesh.py:25-52. The JAX trainer jits one
SPMD program over a 1-D `data` mesh: the batch is sharded over the chips,
parameters and optimizer state are replicated, and the program computes
exactly the function of the whole batch (BatchNorm's statistics and every
masked mean are taken over all chips' rows). Here each chip is a process of
a torch.distributed group (torchrun, or a caller's own spawn) holding the
rows [r * bs / N, (r + 1) * bs / N) of the global batch, and the same
function is kept by hand:

  * BatchNorm sums (sum x, sum x*x, rows) across ranks through
    `all_reduce_sum`, a differentiable all-reduce whose backward sums too
    (models/ops.py:batch_norm_train);
  * every masked mean of the objective divides a local sum by the GLOBAL
    denominator (`global_sum`, no gradient), so the local losses and
    reports are partial sums whose sum over the ranks is the single-process
    value (models/metrics.py, models/objective.py);
  * after backward the gradients are summed in one flat bucket
    (`all_reduce_gradients`), so grad_norm, the clip and Adam see the
    global gradient and stay identical on every rank.

A textbook DDP would take per-replica BatchNorm statistics and average
per-replica losses: another function of the batch. Without a process group
(world 1, no torchrun variables) every call here is the identity and the
code path is the single-process one. Nothing falls back: a group that fails
to form raises.

The 2-D `data x demo` mesh (port of demo2program_tpu/parallel/mesh.py:55-85,
`make_mesh_2d`, `shard_batch_2d`) also shards the k seen demos of each task:
rank r is data index r // D and demo index r % D, and holds the rows of its
data index and, of the seen-demo keys, the demos [j * k / D, (j + 1) * k /
D) of its demo index j. Its `demo_group` is the D ranks of one data index
(one task's demos between them), its `data_group` the dp ranks of one demo
index; `group` stays the world. Whatever the demo group computes from
every demo (the pooled summaries, the program and test-demo decoders and
their losses) it computes replicated, and a replicated value behaves as a
D-fold duplicate of the global rows. So the world reductions above keep
the global value: BatchNorm's sums, the masked means' denominators and
`batch_mean`'s row count all grow D-fold with their numerators, each
replica's loss is 1/D of its rows' share, and each replica's gradient
arrives at the demo-sharded values as 1/D, which the demo-group sum in the
backward of `demo_sum` and `all_gather_demos` makes whole. Three kinds of
reduction change:

  * a mean over the k demos (the encoders' summaries, the baselines'
    avgpool) is a demo-group `demo_sum` of the local sum over the GLOBAL k
    (`demo_mean`); a pooling that needs every demo (RNPool's pairs, maxpool,
    concat, the induction model's attention memory) gathers them first
    (`all_gather_demos`);
  * a per-demo term of the objective normalises each demo by its own mask
    sum over the global batch: the rows of a demo index are spread over
    its data group, so the denominators sum over the data group only
    (`data_axis`), and the mean over k divides by the global k
    (models/metrics.py:k_mean);
  * the rows of the global batch are split over the dp data indices
    (`shard_rows`), not over the world, and a per-example output of the
    replicated decoders is gathered over the data index only
    (`gather_rows(t, data_axis(mesh))`): the world's gather would repeat
    every row D times.

With bf16 compute every collective reduces what JAX's jit reduces (each
function's docstring says which dtype it is fed and why): the mean over the
k demos sums in f32 and rounds once, as jnp.mean of bf16 does; the sums of
BatchNorm, of the objective's denominators, of the report and of the
gradients are f32 anyway; the gather of bf16 demo features is exact in any
dtype, and its backward sums in f32. A backend that refuses a dtype
raises; nothing is cast to dodge it.
"""

import dataclasses
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from demo2program_tpu_torch.utils import log


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in a data mesh: `rank` in [0, world) (None
    for a process left outside a smaller mesh: it takes no step), the mesh
    size `world`, the `device` of its rows, and the process `group` of the
    mesh's ranks (None: world 1 without a process group, where every
    reduction is the identity). A 2-D `data x demo` mesh (make_mesh_2d)
    has `demo_par` D > 1 demo indices, the process group of this rank's
    demo index (`demo_group`, None at D 1) and of its data index
    (`data_group`, None at dp 1); a 1-D mesh is the D = 1 case."""
    rank: object
    world: int
    device: torch.device
    group: object = None
    backend: object = None
    demo_par: int = 1
    demo_group: object = None
    data_group: object = None

    @property
    def dp(self):
        """The number of data indices (row shards)."""
        return self.world // self.demo_par

    @property
    def data_rank(self):
        return self.rank // self.demo_par

    @property
    def demo_rank(self):
        return self.rank % self.demo_par

    @property
    def distributed(self):
        """Do the reductions run collectives?"""
        return self.group is not None

    @property
    def active(self):
        """Does this process hold rows of the batch?"""
        return self.rank is not None

    def __deepcopy__(self, memo):  # a process group cannot be copied
        return self

    def barrier(self):
        if not self.distributed:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def process_world():
    """The number of processes of this run: the process group's, else
    torchrun's WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def data_parallel_size(batch_size, world):
    """The JAX trainer's device-count rule
    (demo2program_tpu/train/trainer.py:121-129): the largest device count
    that divides the batch and is at most `world`, with its warning when it
    is smaller."""
    n = world
    while batch_size % n != 0:
        n -= 1
    if n != world:
        log.warn("batch_size %d not divisible by %d devices; using a "
                 "%d-device mesh", batch_size, world, n)
    return n


def _default_backend(device):
    return "nccl" if device.type == "cuda" else "gloo"


def _device(device):
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
    return device


def _process_group(backend, device, rank, world_size, init_method):
    """The process group of make_mesh and make_mesh_2d (their docstrings),
    formed here if there is none yet -> (device, backend, world, rank), or
    None without a group and without torchrun's variables."""
    device = _device(device)
    if not dist.is_initialized():
        env_world = os.environ.get("WORLD_SIZE")
        if world_size is None and env_world is None:
            return None
        world_size = int(env_world if world_size is None else world_size)
        rank = int(os.environ["RANK"] if rank is None else rank)
        backend = backend or _default_backend(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"{backend} asked for")
    world, rank = dist.get_world_size(), dist.get_rank()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device, dist.get_backend(), world, rank


def make_mesh(num_devices=None, backend=None, device=None, *, rank=None,
              world_size=None, init_method=None):
    """The data mesh of this process.

    With no process group yet, one is formed when torchrun's variables
    (RANK, WORLD_SIZE, LOCAL_RANK) or `rank` and `world_size` are given:
    `backend` defaults to nccl for a cuda device and gloo for the CPU, and
    `init_method` to env:// (torchrun's MASTER_ADDR and MASTER_PORT).
    Without either, the mesh is world 1 with no group. A group formed
    earlier (by a caller's spawn) is taken as it is; `backend`, if given,
    must be its backend. `device` "cuda" means cuda:LOCAL_RANK (NCCL needs
    one card a rank; gloo takes CUDA tensors, so two gloo ranks may share a
    card when the caller names it, e.g. "cuda:0"). `num_devices` (default:
    the whole world) cuts the mesh to ranks [0, num_devices); the other
    ranks get a mesh with rank None."""
    formed = _process_group(backend, device, rank, world_size, init_method)
    if formed is None:
        if num_devices not in (None, 1):
            raise ValueError(f"a {num_devices}-device mesh asked for, but "
                             f"no process group and no torchrun variables")
        return DataMesh(0, 1, _device(device))  # the single-process path
    device, backend, world, rank = formed
    n = world if num_devices is None else num_devices
    if not 1 <= n <= world:
        raise ValueError(f"a {n}-device mesh asked for in a world of "
                         f"{world} processes")
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    inside = rank < n
    log.info("data mesh: rank %d of a %d-process %s group on %s, mesh of %d"
             "%s", rank, world, backend, device, n,
             "" if inside else " (outside: takes no step)")
    return DataMesh(rank if inside else None, n, device,
                    group if inside else None, backend)


def make_mesh_2d(dp, demo_par, backend=None, device=None, *, rank=None,
                 world_size=None, init_method=None):
    """The 2-D `data x demo` mesh of this process (JAX's make_mesh_2d:
    the devices reshaped to (dp, demo_par)): rank r is data index r //
    demo_par and demo index r % demo_par. The process group is taken or
    formed as make_mesh does (same arguments); its world must be dp *
    demo_par. Every rank forms every demo group (the ranks of one data
    index), then every data group (the ranks of one demo index), in that
    order, as dist.new_group asks; a group of one rank is not formed (None:
    its reductions are the identity). Without a process group, dp *
    demo_par must be 1: world 1, every call the identity."""
    formed = _process_group(backend, device, rank, world_size, init_method)
    if formed is None:
        if dp * demo_par != 1:
            raise ValueError(f"a {dp} x {demo_par} mesh asked for, but no "
                             f"process group and no torchrun variables")
        return DataMesh(0, 1, _device(device))
    device, backend, world, rank = formed
    if dp < 1 or demo_par < 1 or dp * demo_par != world:
        raise ValueError(f"a {dp} x {demo_par} mesh asked for in a world of "
                         f"{world} processes")

    def groups(members):  # -> this rank's group among `members`
        mine = None
        for ranks in members:
            if len(ranks) > 1:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine = g
        return mine

    demo_group = groups([[i * demo_par + j for j in range(demo_par)]
                         for i in range(dp)])
    data_group = groups([[i * demo_par + j for i in range(dp)]
                         for j in range(demo_par)])
    mesh = DataMesh(rank, world, device, dist.group.WORLD, backend, demo_par,
                    demo_group, data_group)
    log.info("data x demo mesh: rank %d of a %d-process %s group on %s, "
             "%d x %d, data index %d, demo index %d", rank, world, backend,
             device, dp, demo_par, mesh.data_rank, mesh.demo_rank)
    return mesh


def _shard(x, dim, n_shards, index, what):
    n = x.shape[dim]
    if n % n_shards:
        raise ValueError(f"{n} {what} do not split over {n_shards} ranks")
    per = n // n_shards
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * per, (index + 1) * per)
    return x[tuple(sl)]


def shard_rows(x, mesh, dim=0):
    """The rank's rows [i * n / dp, (i + 1) * n / dp) of `x` (numpy array
    or tensor) along `dim`, i its data index: JAX's P("data") order (on a
    1-D mesh dp is the world and i the rank)."""
    if mesh is None or mesh.dp == 1:
        return x
    return _shard(x, dim, mesh.dp, mesh.data_rank, "rows")


def shard_batch(batch, mesh):
    """The rank's rows of every array of a batch dict (ids too)."""
    return {k: shard_rows(v, mesh) for k, v in batch.items()}


# the seen-demo keys, (bs, k, ...): sharded on both axes of a 2-D mesh;
# every other key on the data axis only. The compact wire's keys are among
# them, so the replay runs on the rank's demos (the JAX package's list,
# demo2program_tpu/parallel/mesh.py:71-73), and so are the ViZDoom device
# cache's frames and percepts (dc_s_h, dc_per), which JAX's list leaves to
# jit to reshard: a rank here expands its own demos only.
DEMO_AXIS_KEYS = ("s_h", "a_h", "a_h_tokens", "per", "demo_len",
                  "init_pos", "init_pos_len",
                  "c_wall", "c_marker", "c_agent", "c_a_raw",
                  "dc_s_h", "dc_per")


def shard_demos(batch, mesh):
    """The rank's demos of the seen-demo keys of a batch dict whose rows
    are already the rank's (numpy arrays or tensors; every other key as it
    is): the identity on a 1-D mesh."""
    if mesh is None or mesh.demo_par == 1:
        return batch
    return {k: _shard(v, 1, mesh.demo_par, mesh.demo_rank, f"demos of {k!r}")
            if k in DEMO_AXIS_KEYS else v for k, v in batch.items()}


def shard_batch_2d(batch, mesh):
    """The rank's part of a global batch dict on a 2-D mesh (JAX's
    shard_batch_2d): the rows of its data index of every key (ids too),
    and of the seen-demo keys its demos [j * k / D, (j + 1) * k / D), j its
    demo index. Raises ValueError when the rows do not split over dp or
    the demos over D."""
    return shard_demos(shard_batch(batch, mesh), mesh)


@torch.no_grad()
def demo_group_rows(batch, mesh):
    """The rows of the rank's data index, from a batch dict of which each
    rank of the demo group holds rows of its own (every demo; tensors on
    the mesh's device): the group's rows in demo-rank order, and of the
    seen-demo keys only this rank's demos [j * k / D, (j + 1) * k / D)
    (the identity on a 1-D mesh). One all_to_all a key over the demo group:
    a rank sends each peer only the demos that peer keeps, so the frames,
    most of the bytes, cross at 1/D of what an all-gather and slice would
    move; the other keys are whole rows that every peer needs (an
    all-gather). Raises ValueError when the demos do not split over D."""
    if mesh is None or mesh.demo_group is None:
        return batch
    D, out = mesh.demo_par, {}
    for key, t in batch.items():
        if key in DEMO_AXIS_KEYS:
            n, k = t.shape[:2]
            if k % D:
                raise ValueError(f"{k} demos of {key!r} do not split over "
                                 f"{D} demo indices")
            # (n, D, k / D, ...) -> (D, n, k / D, ...): peer j's part first
            send = t.reshape((n, D, k // D) + tuple(t.shape[2:])).transpose(
                0, 1)
        else:
            send = t.unsqueeze(0).expand((D,) + tuple(t.shape))
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.demo_group)
        out[key] = recv.reshape((D * send.shape[1],) + tuple(send.shape[2:]))
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum across the group; the gradient of each rank's input is the sum
    of the gradients of every rank's output."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t, mesh, group=None):
    """Differentiable sum of `t` across the ranks of `group` (default: the
    mesh's world; the identity without one)."""
    if mesh is None or not mesh.distributed:
        return t
    group = mesh.group if group is None else group
    return _AllReduceSum.apply(t, group)


def demo_sum(t, mesh):
    """Differentiable sum of `t` across the rank's demo group (the identity
    on a 1-D mesh), in t's dtype: demo_mean feeds it f32."""
    if mesh is None or mesh.demo_group is None:
        return t
    return all_reduce_sum(t, mesh, mesh.demo_group)


def demo_mean(x, mesh, dim=1):
    """The mean of `x` over `dim` (an int or a tuple of dims) whose first
    is the demo axis, holding the rank's k / D demos, and every other dim
    whole: the demo group's sum of the local sums over the global count,
    replicated across the demo group and differentiable (x.mean(dim) on a
    1-D mesh). The sums run in f32 and the mean is cast to x's dtype once,
    as jnp.mean of bf16 does (f32 reduce_sum, divide, one cast), so under
    GSPMD JAX's demo mean all-reduces f32 partial sums; summed in bf16, the
    local sum, the group's sum and the division would round three times.
    The backward is the demo group's sum of the f32 gradient."""
    if mesh is None or mesh.demo_group is None:
        return x.mean(dim)
    dims = (dim,) if isinstance(dim, int) else dim
    count = math.prod(x.shape[d] for d in dims) * mesh.demo_par
    total = demo_sum(x.sum(dim, dtype=torch.float32), mesh)
    return (total / count).to(x.dtype)


class _AllGatherDemos(torch.autograd.Function):
    """The demo group's slices of `t` along `dim`, in demo-rank order; the
    gradient of each rank's slice is its part of the sum of every rank's
    output gradient. Each rank writes its slice into zeros of the gathered
    shape and the group sums them (all_reduce takes CUDA tensors on gloo and
    NCCL; adding zeros is exact, so a bf16 gather is the features bit for
    bit). The backward sums the replicas' shares of the gradient in f32
    and rounds once to the input's dtype: the gradient of JAX's global
    batch function has no such sum (the shares are the replicated
    decoders' here), so under bf16 compute the sum must not round at each
    of its D - 1 additions."""

    @staticmethod
    def forward(ctx, t, dim, demo_rank, demo_par, group):
        ctx.dim, ctx.group = dim, group
        ctx.part = slice(demo_rank * t.shape[dim],
                         (demo_rank + 1) * t.shape[dim])
        shape = list(t.shape)
        shape[dim] *= demo_par
        out = t.new_zeros(shape)
        out.narrow(dim, ctx.part.start, t.shape[dim]).copy_(t)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        total = grad.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        return (total.narrow(ctx.dim, ctx.part.start,
                             ctx.part.stop - ctx.part.start).to(grad.dtype),
                None, None, None, None)


def all_gather_demos(t, mesh, dim=1):
    """Every demo of the rank's data index: the demo group's slices of `t`
    along `dim`, in demo-rank order, on every rank of the group;
    differentiable (the identity on a 1-D mesh)."""
    if mesh is None or mesh.demo_group is None:
        return t
    return _AllGatherDemos.apply(t, dim, mesh.demo_rank, mesh.demo_par,
                                 mesh.demo_group)


def data_axis(mesh):
    """The mesh of the data axis alone: on a 2-D mesh, the rank's data
    group, the dp ranks that hold the same demos of other rows (a mesh of
    world dp whose rank is the data index), over which a per-demo term of
    the objective reduces; else `mesh`."""
    if mesh is None or mesh.demo_par == 1:
        return mesh
    return DataMesh(mesh.data_rank, mesh.dp, mesh.device, mesh.data_group,
                    mesh.backend)


@torch.no_grad()
def global_sum(t, mesh):
    """Sum of `t` across the mesh's ranks, outside autograd: the
    denominators of the objective's masked means (f32 mask sums in every
    compute dtype)."""
    if mesh is None or not mesh.distributed:
        return t.detach()
    out = t.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def world_of(mesh):
    return 1 if mesh is None else mesh.world


@torch.no_grad()
def global_report(report, mesh):
    """A dict of 0-d partial sums -> their sums across the ranks, in one
    f32 all-reduce (the identity without a group). The objective's scalars
    are f32 in every compute dtype: f32 labels and masks promote bf16
    logits' terms, as in the JAX objective."""
    if mesh is None or not mesh.distributed or not report:
        return report
    keys = list(report)
    values = torch.stack([report[k].detach().float() for k in keys])
    dist.all_reduce(values, group=mesh.group)
    return dict(zip(keys, values.unbind()))


@torch.no_grad()
def all_reduce_gradients(params, mesh):
    """Sum the gradients of `params` across the ranks in one flat bucket
    (a parameter without a gradient counts as zeros, as in the JAX
    gradient tree). The parameters and so their gradients are f32 in every
    compute dtype (train/step.py:compute_call)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is None or not mesh.distributed:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


@torch.no_grad()
def gather_rows(t, mesh):
    """Every rank's rows of `t` (a tensor on the mesh's device), in rank
    order, on every rank: each rank writes its rows into zeros of the
    global shape and the group sums them (all_reduce takes CUDA tensors on
    both backends; adding zeros is exact in any dtype). On a 2-D mesh,
    gather the rows of the data indices with `data_axis(mesh)`."""
    if mesh is None or not mesh.distributed:
        return t
    n = t.shape[0]
    out = t.new_zeros((n * mesh.world,) + tuple(t.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = t
    dist.all_reduce(out, group=mesh.group)
    return out


def gather_host_rows(arrays, mesh):
    """gather_rows of numpy arrays (through the mesh's device) -> numpy."""
    if mesh is None or not mesh.distributed:
        return arrays
    return {k: gather_rows(torch.as_tensor(np.ascontiguousarray(v),
                                           device=mesh.device),
                           mesh).cpu().numpy()
            for k, v in arrays.items()}
