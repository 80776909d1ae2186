"""Basic NN blocks with reference-op parity.

Port of demo2program_tpu/models/ops.py. Quirks kept:
  * BNAct applies the ACTIVATION FIRST, then batch norm (eps 1e-3);
  * lrelu has leak 0.2 in the f1/f2 form, and its derivative at 0 is
    JAX's: d|x|/dx = 1 at x = 0 (torch.abs gives 0). Exact zeros are common
    in training: the zero-padded frames past each demo's length meet zero
    conv biases at initialisation;
  * convs are 3x3, stride 2, with flax/TF "SAME" padding: for stride 2 on
    the Karel grids (8 -> 4 -> 2 -> 1) that pads 0 before and 1 after, which
    `padding=1` would not reproduce.

Layouts: convs run NCHW inside; the public StateEncoder keeps the JAX
package's NHWC layout. Dense and conv weights are stored the torch way
((out, in) and OIHW); models/convert.py transposes flax's (in, out) / HWIO.

Mixed precision (`--compute_dtype bfloat16`, train/step.py:compute_call):
the layers see bf16 copies of their parameters, and every layer here ends in
the dtype flax's ends in. flax promotes (jnp.promote_types) where torch
raises: a Dense or Conv on an f32 input computes in f32 with the bf16
weights' rounded values (`promoted`); BatchNorm takes its batch statistics
in f32 whatever the input, normalises in f32, and returns the promoted dtype
of (input, scale, bias); the running statistics are stored in f32 but SEEN
in the parameters' dtype (the JAX step casts every f32 leaf of batch_stats
along with the params), so eval mode normalises with bf16 statistics in the
promoted dtype of its input, and train mode stores 0.9 * f32(bf16(running))
+ 0.1 * the f32 batch statistic: the stored value is rounded through bf16
on every step. (flax writes 0.9 * running as a bf16 product; XLA on the CPU
keeps it in f32, its excess precision, and that is the value held here.)

`init_parameters` draws the flax initializers from one torch.Generator:
lecun-normal (truncated) Dense/Conv kernels, zero biases, unit BN scale,
U[0, 0.02) embeddings and glorot-uniform LSTM kernels.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from demo2program_tpu_torch.ops.fused_lstm import FusedLSTMCell
from demo2program_tpu_torch.parallel.mesh import all_reduce_sum

BN_EPS = 1e-3
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch statistic


def make_lstm_cell(in_features, units, impl="xla"):
    """Every JAX cell implementation maps to the fused CUDA cell: "pallas"
    and "pallas_jnp" share its parameter layout, and "xla" checkpoints are
    folded into it by models/convert.py."""
    if impl not in ("xla", "pallas", "pallas_jnp"):
        raise ValueError(f"unknown cell impl {impl!r}")
    return FusedLSTMCell(in_features, units)


def lrelu(x, leak=0.2):
    f1 = 0.5 * (1 + leak)
    f2 = 0.5 * (1 - leak)
    return f1 * x + f2 * torch.where(x >= 0, x, -x)


def promoted(*tensors):
    """jnp.promote_types over the dtypes of `tensors` (None entries
    skipped): float32 wins over bfloat16."""
    dtype = None
    for t in tensors:
        if t is not None:
            dtype = t.dtype if dtype is None else torch.promote_types(
                dtype, t.dtype)
    return dtype


def _to(t, dtype):
    return None if t is None else t.to(dtype)


def _normalize(bn, x, mean, var):
    """flax `_normalize`: (x - mean) * (rsqrt(var + eps) * scale) + bias,
    each product in the promoted dtype of its operands, the result in the
    promoted dtype of (x, scale, bias)."""
    shape = [1, -1] + [1] * (x.dim() - 2)
    # rsqrt in f32, rounded once: torch's bf16 rsqrt on the CPU is an ulp
    # off where flax's (and the card's) is correctly rounded
    inv = torch.rsqrt((var + bn.eps).float()).to(var.dtype)
    scale = inv * bn.weight
    y = (x - mean.reshape(shape)) * scale.reshape(shape) + bn.bias.reshape(
        shape)
    return y.to(promoted(x, bn.weight, bn.bias))


def batch_norm_train(bn, x, mesh=None):
    """flax `BatchNorm(use_running_average=False)` on the channels of dim 1,
    with the parameters and buffers of the torch module `bn`: normalise with
    the batch mean and the BIASED batch variance, computed as flax does
    (in f32: E[x^2] - E[x]^2, clipped at 0), and move the running statistics
    by running = 0.9 * running + 0.1 * batch, `running` as seen in the
    parameters' dtype (the module docstring). torch's own training mode
    moves running_var by the unbiased variance (a factor n / (n - 1)).

    The statistics are those of the global batch: sum x, sum x*x and the
    row count are summed across the ranks of `mesh` by a differentiable
    all-reduce (parallel/mesh.py), as the JAX step's BatchNorm sees every
    chip's rows; every rank moves its running statistics identically.
    Without a process group the sums are the rank's own."""
    dims = [0] + list(range(2, x.dim()))
    xf = x.float()
    rows = xf.new_full((1,), xf.numel() // xf.shape[1])
    sums = all_reduce_sum(torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                                     rows]), mesh)
    count = sums[-1]
    mean, sq = (sums[:-1] / count).chunk(2)
    var = torch.clamp(sq - mean * mean, min=0.0)
    with torch.no_grad():
        for running, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            seen = running.to(bn.weight.dtype).float()
            running.copy_(BN_MOMENTUM * seen + (1.0 - BN_MOMENTUM) * stat)
    return _normalize(bn, x, mean, var)


def batch_norm_eval(bn, x):
    """flax `BatchNorm(use_running_average=True)`: the running statistics
    as the model sees them, in the parameters' dtype."""
    if x.dtype == bn.weight.dtype == torch.float32:
        return bn(x)
    dtype = bn.weight.dtype
    return _normalize(bn, x, bn.running_mean.to(dtype),
                      bn.running_var.to(dtype))


class MeshModule(nn.Module):
    """A module that reduces across the ranks of a data mesh: BatchNorm's
    statistics, and the pooling over the k demos on a 2-D mesh. `mesh` is
    the mesh of the forward in progress (`use_mesh`), None outside one."""
    mesh = None


class BNAct(MeshModule):
    """activation ('lrelu' | 'none') -> batch norm over dim 1 (the
    reference order). `train()` / `eval()` is the flax `train` field:
    batch statistics (updating the running ones) or running statistics."""

    def __init__(self, features, activation="lrelu", spatial=False):
        super().__init__()
        self.activation = activation
        bn_cls = nn.BatchNorm2d if spatial else nn.BatchNorm1d
        self.bn = bn_cls(features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        if self.activation == "lrelu":
            x = lrelu(x)
        if self.training:
            return batch_norm_train(self.bn, x, self.mesh)
        return batch_norm_eval(self.bn, x)


@contextlib.contextmanager
def use_mesh(model, mesh):
    """Inside the block, the MeshModules of `model` reduce over `mesh`: the
    train-mode BatchNorms take their statistics over its global batch, and
    on a 2-D mesh the poolings over the k demos reach the demo group's (the
    backward, which runs later, keeps the groups it was given). Nothing to
    do at world 1."""
    if mesh is None or not mesh.distributed:
        yield
        return
    layers = [m for m in model.modules() if isinstance(m, MeshModule)]
    for m in layers:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in layers:
            m.mesh = None


def same_padding(size, kernel, stride):
    """(before, after) padding of flax/TF 'SAME' along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Dense(nn.Linear):
    """flax `Dense`: input, kernel and bias promoted to one dtype first."""

    def forward(self, x):
        dtype = promoted(x, self.weight, self.bias)
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        _to(self.bias, dtype))


class Conv2D(nn.Module):
    """3x3 stride-2 conv (SAME) + (lrelu -> BN) on NCHW input."""

    KERNEL, STRIDE = 3, 2

    def __init__(self, in_features, features):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, self.KERNEL, self.STRIDE)
        self.bn_act = BNAct(features, spatial=True)

    def forward(self, x):
        top, bottom = same_padding(x.shape[2], self.KERNEL, self.STRIDE)
        left, right = same_padding(x.shape[3], self.KERNEL, self.STRIDE)
        conv = self.conv
        dtype = promoted(x, conv.weight, conv.bias)
        x = F.pad(x.to(dtype), (left, right, top, bottom))
        return self.bn_act(F.conv2d(x, conv.weight.to(dtype),
                                    _to(conv.bias, dtype), conv.stride))


class FC(nn.Module):
    """dense + (activation -> BN) on (..., in) input."""

    def __init__(self, in_features, features, activation="lrelu"):
        super().__init__()
        self.dense = Dense(in_features, features)
        self.bn_act = BNAct(features, activation)

    def forward(self, x):
        lead = x.shape[:-1]
        y = self.dense(x).reshape(-1, self.dense.out_features)
        return self.bn_act(y).reshape(*lead, self.dense.out_features)


def _lecun_normal_(weight, fan_in, generator):
    # flax variance_scaling(1, "fan_in", "truncated_normal"): std of the
    # normal truncated at +-2 is scaled back up to sqrt(1/fan_in)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


@torch.no_grad()
def init_parameters(model, generator):
    """Re-draw every parameter of `model` from `generator` with the flax
    initializers, in module order; BN running stats reset to (0, 1).
    Modules of this package that own raw parameters (the LSTM cell, the
    token decoders' embedding, the induction decoder's `manipulation`
    embedding) draw them in `reset_parameters(generator)`."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            # weight[0] spans the fan-in: (in,) or (in, kh, kw)
            _lecun_normal_(module.weight, module.weight[0].numel(),
                           generator)
            if module.bias is not None:
                nn.init.zeros_(module.bias)
        elif isinstance(module, nn.modules.batchnorm._BatchNorm):
            module.reset_parameters()
        elif hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
