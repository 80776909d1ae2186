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
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from demo2program_tpu_torch.utils import log


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place in a 1-D data mesh: `rank` in [0, world) (None
    for a process left outside a smaller mesh: it takes no step), the mesh
    size `world`, the `device` of its rows, and the process `group` of the
    mesh's ranks (None: world 1 without a process group, where every
    reduction is the identity)."""
    rank: object
    world: int
    device: torch.device
    group: object = None
    backend: object = None

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
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not "
                           f"available; pass --device cpu to run on the CPU")
    if not dist.is_initialized():
        env_world = os.environ.get("WORLD_SIZE")
        if world_size is None and env_world is None:
            if num_devices not in (None, 1):
                raise ValueError(f"a {num_devices}-device mesh asked for, "
                                 f"but no process group and no torchrun "
                                 f"variables")
            return DataMesh(0, 1, device)  # the single-process path
        world_size = int(env_world if world_size is None else world_size)
        rank = int(os.environ["RANK"] if rank is None else rank)
        backend = backend or _default_backend(device)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    elif backend is not None and backend != dist.get_backend():
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"{backend} asked for")
    backend = dist.get_backend()
    world, rank = dist.get_world_size(), dist.get_rank()
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                         rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
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


def shard_rows(x, mesh, dim=0):
    """The rank's rows [r * n / N, (r + 1) * n / N) of `x` (numpy array or
    tensor) along `dim`: JAX's P("data") order."""
    if mesh is None or mesh.world == 1:
        return x
    n = x.shape[dim]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks")
    per = n // mesh.world
    index = [slice(None)] * x.ndim
    index[dim] = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return x[tuple(index)]


def shard_batch(batch, mesh):
    """The rank's rows of every array of a batch dict (ids too)."""
    return {k: shard_rows(v, mesh) for k, v in batch.items()}


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


def all_reduce_sum(t, mesh):
    """Differentiable sum of `t` across the mesh's ranks (the identity
    without a group)."""
    if mesh is None or not mesh.distributed:
        return t
    return _AllReduceSum.apply(t, mesh.group)


@torch.no_grad()
def global_sum(t, mesh):
    """Sum of `t` across the mesh's ranks, outside autograd: the
    denominators of the objective's masked means."""
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
    all-reduce (the identity without a group)."""
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
    gradient tree)."""
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
    both backends)."""
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
