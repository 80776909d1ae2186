"""Fused LSTM step: hand-written CUDA kernel + plain PyTorch version.

Port of demo2program_tpu/ops/pallas_lstm.py. Semantics, gate order
(i, f, g, o):

    z  = [x, h] @ W + b          (accumulated in f32)
    c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
    h' = sigmoid(o) * tanh(c')   (gate math in f32, cast to the input dtype)

`fused_lstm_step` dispatches on where its tensors lie: CPU tensors take the
plain version `lstm_step_ref`; CUDA tensors launch the kernel in
csrc/fused_lstm.cu or raise. There is no fallback from the kernel to the
plain version. `fused_lstm_step.launches` counts kernel launches, and
`fused_lstm_step.launches_by_dtype` those of each entry (f32, bf16).

Gradients (pallas_lstm.py:92-107): when grad is enabled and an input needs
one, the step runs through `FusedLSTMStep`, an autograd Function whose
forward is the same dispatch on detached inputs and whose backward
recomputes `lstm_step_ref` from the saved (x, h, c, W, b) and
differentiates it, as the JAX custom VJP's `_bwd` runs `jax.vjp` of
`_lstm_step_ref`. The JAX backward is jnp, not Pallas, so the backward here
is plain PyTorch on either device. Under `torch.no_grad()` the step is the
direct dispatch. Spans (utils/spans.py): `d2p.lstm.step` around
`FusedLSTMCell.forward`, `d2p.lstm.backward` around the backward, on
autograd's thread.

The TPU cell's VMEM-size fallback and 128-lane padding are TPU rules and are
not carried over: the CUDA kernel masks its own ragged edges.
"""

import ctypes
import functools
import math

import torch
from torch import nn

from demo2program_tpu_torch.ops import _build
from demo2program_tpu_torch.utils import spans

_SOURCES = ("fused_lstm.cu",)
_ENTRY = {torch.float32: "d2p_fused_lstm_step_f32",
          torch.bfloat16: "d2p_fused_lstm_step_bf16"}


def lstm_step_ref(x, h, c, w, b):
    """Plain PyTorch version of the kernel: returns (h', c') in x's dtype,
    computed in f32 like the kernel (and the Pallas `_kernel`)."""
    dt = x.dtype
    z = torch.cat([x, h], dim=-1).float() @ w.float() + b.float()
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(dt), c_new.to(dt)


def build():
    """Compile the kernel library if needed: (path, seconds, nvcc output)."""
    return _build.build("fused_lstm", _SOURCES)


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()[0]))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return lib


_PLAN_KEYS = ("grid_x", "grid_y", "grid_z", "cluster", "threads",
              "smem_bytes", "vec")
_PLAN = (ctypes.c_int * len(_PLAN_KEYS))()   # written by every launch
_PLAN_PTR = ctypes.addressof(_PLAN)


def last_plan():
    """The launch configuration the latest kernel launch took: grid,
    blocks per cluster along K (2: the wide variant, 4: the narrow one),
    threads, dynamic shared memory, and whether tiles moved by 16-byte
    async copies (1) or plain loads (0). Adds "blocks"."""
    plan = dict(zip(_PLAN_KEYS, _PLAN))
    plan["blocks"] = plan["grid_x"] * plan["grid_y"] * plan["grid_z"]
    return plan


def _check(x, h, c, w, b):
    tensors = {"x": x, "h": h, "c": c, "w": w, "b": b}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"fused_lstm_step: {name} is on {t.device}, "
                             f"x is on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"fused_lstm_step: {name} is {t.dtype}, "
                            f"x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_lstm_step: {name} is not contiguous")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_lstm_step: unsupported dtype {x.dtype}")
    if x.dim() != 2 or h.dim() != 2:
        raise ValueError("fused_lstm_step: x and h must be 2-D")
    B, D = x.shape
    H = h.shape[1]
    if (h.shape != (B, H) or c.shape != (B, H) or w.shape != (D + H, 4 * H)
            or b.shape != (4 * H,)):
        raise ValueError(
            f"fused_lstm_step: shapes x{tuple(x.shape)} h{tuple(h.shape)} "
            f"c{tuple(c.shape)} w{tuple(w.shape)} b{tuple(b.shape)} do not "
            f"fit x (B, D), h/c (B, H), w (D+H, 4H), b (4H,)")


def _step(x, h, c, w, b):
    """Forward without autograd. CPU: plain version. CUDA: the kernel."""
    if x.device.type == "cpu":
        return lstm_step_ref(x, h, c, w, b)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_lstm_step: no kernel for {x.device}")
    _check(x, h, c, w, b)
    B, D = x.shape
    H = h.shape[1]
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    fn = getattr(_library(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
                 b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), B, D, H,
                 stream, _PLAN_PTR)
    if err != 0:
        raise RuntimeError(f"fused_lstm_step: kernel launch failed with CUDA "
                           f"error {err}")
    fused_lstm_step.launches += 1
    fused_lstm_step.launches_by_dtype[x.dtype] += 1
    return h_out, c_out


class FusedLSTMStep(torch.autograd.Function):
    """The step with the JAX custom VJP's backward: recompute the plain
    version from the saved inputs and take its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, h, c, w, b):
        ctx.save_for_backward(x, h, c, w, b)
        return _step(x, h, c, w, b)

    @staticmethod
    def backward(ctx, dh, dc):
        with spans.span("d2p.lstm.backward"):
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                outputs = lstm_step_ref(*inputs)
            return torch.autograd.grad(outputs, inputs, (dh, dc))


def fused_lstm_step(x, h, c, w, b):
    """One LSTM step -> (h', c'). CPU: plain version. CUDA: the kernel.
    Differentiable through `FusedLSTMStep` when grad is enabled."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, h, c, w, b)):
        return FusedLSTMStep.apply(x, h, c, w, b)
    return _step(x, h, c, w, b)


fused_lstm_step.launches = 0
fused_lstm_step.launches_by_dtype = {dtype: 0 for dtype in _ENTRY}


def reset_launches():
    """Set the launch counts (the total and the one per dtype) to 0."""
    fused_lstm_step.launches = 0
    for dtype in _ENTRY:
        fused_lstm_step.launches_by_dtype[dtype] = 0


class FusedLSTMCell(nn.Module):
    """LSTM cell over the fused step, with PallasLSTMCell's parameter layout:
    one `kernel` (D+H, 4H), glorot-uniform, and one `bias` (4H,), zeros.

    The compute dtype follows the parameters; the carry leaves in exactly
    the dtype it came in (pallas_lstm.py:129-135, 170)."""

    def __init__(self, in_features, features):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features + features,
                                               4 * features))
        self.bias = nn.Parameter(torch.empty(4 * features))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in, fan_out = self.kernel.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        nn.init.uniform_(self.kernel, -limit, limit, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, carry, x):
        """carry (c, h), x (B, D) -> ((c', h'), h'). Span
        `d2p.lstm.step`."""
        with spans.span("d2p.lstm.step"):
            c, h = carry
            dt = self.kernel.dtype
            h_new, c_new = fused_lstm_step(
                x.to(dt), h.to(dt), c.to(dt), self.kernel, self.bias)
            return (c_new.to(c.dtype), h_new.to(h.dtype)), h_new
