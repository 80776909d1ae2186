"""The fused LSTM CUDA kernel vs its plain PyTorch version, on the card.

Marked `cuda`: skipped without a CUDA card (the kernel has no CPU mode).
This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(`--noconftest` skips tests/conftest.py, which sets up JAX.)
"""

import math

import numpy as np
import pytest
import torch

from demo2program_tpu_torch.ops.fused_lstm import (
    fused_lstm_step, last_plan, lstm_step_ref)

# max |kernel - plain| <= atol + atol * |plain|. f32: 3xTF32 products summed
# in another order than cuBLAS's f32 GEMM; bf16: one rounding of the stored
# result (2^-8 relative).
ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
BATCHES = (1, 20, 32, 33, 64, 160, 200, 320)
# (D, H): the encoder's first pass, the 512-wide layers, and shapes whose
# rows are not 16-byte aligned (13, 100) or narrower than one block (64)
WIDTHS = ((48, 512), (512, 512), (13, 100), (48, 64))
# (B, D) at H = 512 that only the induction baseline runs: its demo
# encoder's input (48 CNN features + 5 percepts) at B = bs * k, and its
# attention decoder's [embedding, attention] at B = bs * test_k
BASELINE_SHAPES = [(320, 53), (160, 1024)]
# (B, D) of beam search's program decoder: K = 5 beams of bs = 32 rows
BEAM_SHAPES = [(160, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")


@pytest.fixture(autouse=True)
def _no_tf32():
    """The plain version's matmul must run in full f32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(B, D, H, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, D).astype(np.float32),
            r.randn(B, H).astype(np.float32),
            r.randn(B, H).astype(np.float32),
            (r.randn(D + H, 4 * H) * 0.1).astype(np.float32),
            (r.randn(4 * H) * 0.1).astype(np.float32))


def _on_card(arrays, dtype):
    return [torch.from_numpy(a).to("cuda", getattr(torch, dtype))
            for a in arrays]


def _assert_close(kernel, plain, dtype):
    for k, r in zip(kernel, plain):
        assert k.dtype == getattr(torch, dtype)
        torch.testing.assert_close(k.float(), r.float(), atol=ATOL[dtype],
                                   rtol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_kernel_matches_plain(cuda, B, D, H, dtype):
    """Both variants (wide and split-K), both instances (16-byte copies and
    the edge path), and every ragged B, D and H edge."""
    args = _on_card(_inputs(B, D, H, seed=B + D + H), dtype)
    before = fused_lstm_step.launches
    out = fused_lstm_step(*args)
    ref = lstm_step_ref(*args)
    torch.cuda.synchronize()
    assert fused_lstm_step.launches == before + 1
    _assert_close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_takes_unaligned_tensors(cuda, dtype):
    """x, h and W that start two elements past a 16-byte boundary take the
    edge instance (plain loads) and give the same result."""
    B, D, H = 32, 48, 64
    args = _on_card(_inputs(B, D, H, seed=5), dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
        view = buf[2:].view(t.shape)
        view.copy_(t)
        return view

    x, h, c, w, b = args
    out = fused_lstm_step(shifted(x), shifted(h), c, shifted(w), b)
    assert last_plan()["vec"] == 0
    _assert_close(out, lstm_step_ref(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D", [(32, 512), (320, 48), (320, 512)]
                         + BEAM_SHAPES + BASELINE_SHAPES)
def test_scan_matches_plain(cuda, B, D, dtype):
    """20 steps, each fed the kernel's own (h, c), against the plain version
    fed its own. Weights are glorot-uniform as in the model, so the cell
    contracts and errors do not compound: the drift bound after 20 steps is
    the one-step tolerance."""
    H = 512
    r = np.random.RandomState(B + D)
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    w = r.uniform(-limit, limit, (D + H, 4 * H)).astype(np.float32)
    b = (r.randn(4 * H) * 0.1).astype(np.float32)
    xs = [r.randn(B, D).astype(np.float32) for _ in range(20)]
    h0 = (r.randn(B, H) * 0.5).astype(np.float32)
    w, b, h0, *xs = _on_card([w, b, h0, *xs], dtype)
    kernel = plain = (h0, h0.clone())
    for x in xs:
        kernel = fused_lstm_step(x, *kernel, w, b)
        plain = lstm_step_ref(x, *plain, w, b)
    _assert_close(kernel, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D", [(32, 512), (320, 512), (20, 13)])
def test_kernel_is_deterministic(cuda, B, D, dtype):
    """Two launches on the same inputs are bitwise equal: the split-K
    cluster adds its partial tiles in rank order, without atomics."""
    args = _on_card(_inputs(B, D, 512, seed=3), dtype)
    h1, c1 = fused_lstm_step(*args)
    h2, c2 = fused_lstm_step(*args)
    assert torch.equal(h1, h2) and torch.equal(c1, c2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_plan_fills_the_card(cuda, dtype):
    """The program decoder's B = 32 runs the narrow variant, clusters of 4
    blocks along K, 128 blocks; B = 320 runs the wide variant, clusters of
    2, 320 blocks. At H = 100 the wide grid (7 x 5 x 2) has fewer blocks
    than the card has SMs, so B = 320 runs narrow; its rows are not 16-byte
    aligned, so it takes the edge instance. Each plan is the one the launch
    took."""
    for (B, D, H), cluster, blocks, vec in (((32, 512, 512), 4, 128, 1),
                                            ((320, 512, 512), 2, 320, 1),
                                            ((320, 13, 100), 4, 280, 0)):
        fused_lstm_step(*_on_card(_inputs(B, D, H, seed=1), dtype))
        plan = last_plan()
        assert (plan["cluster"], plan["blocks"], plan["vec"]) == (
            cluster, blocks, vec), (B, D, H, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,blocks,vec", [(320, 53, 320, 0),
                                            (160, 1024, 192, 1)])
def test_baseline_shapes_match_plain(cuda, B, D, blocks, vec, dtype):
    """The induction baseline's shapes at H = 512, one step: its demo
    encoder (D = 53 is no multiple of a 16-byte chunk, so the edge
    instance with plain loads runs) and its attention decoder (K = D + H =
    1536, a wide grid of 32 x 3 x 2 blocks at B = 160)."""
    H = 512
    r = np.random.RandomState(B + D)
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    args = _on_card([r.randn(B, D).astype(np.float32),
                     r.randn(B, H).astype(np.float32),
                     r.randn(B, H).astype(np.float32),
                     r.uniform(-limit, limit, (D + H, 4 * H)).astype(
                         np.float32),
                     (0.1 * r.randn(4 * H)).astype(np.float32)], dtype)
    before = fused_lstm_step.launches
    out = fused_lstm_step(*args)
    plan = last_plan()
    assert fused_lstm_step.launches == before + 1
    assert (plan["cluster"], plan["blocks"], plan["vec"]) == (2, blocks, vec)
    _assert_close(out, lstm_step_ref(*args), dtype)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, h, c, w, b = _on_card(_inputs(32, 48, 64, seed=0), "float32")
    with pytest.raises(ValueError, match="contiguous"):
        fused_lstm_step(x.t().contiguous().t(), h, c, w, b)
    with pytest.raises(TypeError):
        fused_lstm_step(x, h, c.double(), w, b)
    with pytest.raises(ValueError, match="shapes"):
        fused_lstm_step(x, h, c, w[1:], b)
    with pytest.raises(ValueError, match="shapes"):
        fused_lstm_step(x, h, c, w[1:].requires_grad_(), b)


def _grads_via(step, inputs, n_steps, seed):
    """Gradients of sum(h_T * u) + sum(c_T * v) w.r.t. (xs, h0, c0, W, b)
    after `n_steps` steps of `step`, one x per step."""
    xs, h0, c0, w, b = [t.detach().clone().requires_grad_() for t in inputs]
    g = torch.Generator(device="cuda").manual_seed(seed)
    u, v = (torch.randn(h0.shape, generator=g, device="cuda")
            for _ in range(2))
    h, c = h0, c0
    for t in range(n_steps):
        h, c = step(xs[t], h, c, w, b)
    grads = torch.autograd.grad((h * u).sum() + (c * v).sum(),
                                (xs, h0, c0, w, b))
    return h, grads


# bf16 gradients, kernel forward vs plain forward, as a share of each
# gradient's largest element. One step: 0 (the backward recomputes the plain
# version from the same saved inputs, whatever the forward stored). A
# 20-step scan: at most 7.8e-3, one bf16 ulp of the largest (W at (320,
# 512); NVIDIA H100 80GB HBM3, 700.00 W), since the carries differ by an
# ulp on some elements.
BF16_GRAD_TOL = {1: 1e-3, 20: 0.02}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_steps", [1, 20])
@pytest.mark.parametrize("B,D", [(32, 48), (320, 48), (32, 512), (320, 512)]
                         + BASELINE_SHAPES)
def test_autograd_matches_plain(cuda, B, D, n_steps, dtype):
    """FusedLSTMStep on the card (the kernel forward, one launch a step,
    and the backward recomputing the plain version from the saved inputs)
    against plain autograd through lstm_step_ref, at the four eval shapes
    and the induction baseline's two, for one step and a 20-step scan.
    f32: grads of x, h, c, W and b within 1e-4 + 1e-4 * |ref|: the kernel's
    forward differs from the plain one by ~1e-6, and the backward is the
    same plain computation. bf16 (what `--compute_dtype bfloat16` runs):
    every gradient comes back bf16, and lies within BF16_GRAD_TOL of its
    largest element of the plain one: the kernel's h', c' differ from the
    plain version's by one bf16 ulp (7.8e-3 at 1.0) on some elements, each
    step's backward recomputes from its saved bf16 inputs, and a 20-step
    scan carries the difference through the carry."""
    H = 512
    r = np.random.RandomState(B + D + n_steps)
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    inputs = _on_card([
        r.randn(n_steps, B, D).astype(np.float32),
        (0.5 * r.randn(B, H)).astype(np.float32),
        (0.5 * r.randn(B, H)).astype(np.float32),
        r.uniform(-limit, limit, (D + H, 4 * H)).astype(np.float32),
        (0.1 * r.randn(4 * H)).astype(np.float32)], dtype)
    before = fused_lstm_step.launches
    h_k, grads_k = _grads_via(fused_lstm_step, inputs, n_steps, seed=B)
    assert fused_lstm_step.launches == before + n_steps
    assert h_k.grad_fn.name() == "FusedLSTMStepBackward"
    h_r, grads_r = _grads_via(lstm_step_ref, inputs, n_steps, seed=B)
    assert fused_lstm_step.launches == before + n_steps
    for name, k, ref in zip(("x", "h", "c", "W", "b"), grads_k, grads_r):
        assert k.dtype == ref.dtype == getattr(torch, dtype), name
        if dtype == "float32":
            torch.testing.assert_close(
                k, ref, atol=1e-4, rtol=1e-4,
                msg=lambda m, name=name: f"{name}: {m}")
            continue
        share = ((k.float() - ref.float()).abs().max()
                 / ref.float().abs().max()).item()
        print(f"bf16 grad {name} B={B} D={D} steps={n_steps}: "
              f"{share:.3g} of the largest")
        assert share <= BF16_GRAD_TOL[n_steps], (name, share)


def _tf32(a):
    """Round f32 to the nearest TF32 (10 mantissa bits), as the kernel's
    split does."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)


@pytest.mark.parametrize("B,D", [(32, 48), (320, 48), (32, 512), (320, 512)]
                         + BEAM_SHAPES + BASELINE_SHAPES)
def test_f32_tolerance_rejects_single_pass_tf32(B, D):
    """The f32 tolerance tells the 3xTF32 split from one TF32 pass at every
    model shape, with glorot weights and N(0, 1) activations as in
    chip_smoke.py: z = [x, h] @ W from TF32-rounded operands (products and
    sums exact in f64) breaks it; the split's three products keep it."""
    H = 512
    r = np.random.RandomState(B + D)
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    x, h, c = (torch.from_numpy(r.randn(B, n).astype(np.float32))
               for n in (D, H, H))
    w = torch.from_numpy(
        r.uniform(-limit, limit, (D + H, 4 * H)).astype(np.float32))
    b = torch.from_numpy((r.randn(4 * H) * 0.1).astype(np.float32))
    plain = lstm_step_ref(x, h, c, w, b)
    a = torch.cat([x, h], dim=-1)
    a_big, w_big = _tf32(a), _tf32(w)
    a_small, w_small = _tf32(a - a_big), _tf32(w - w_big)

    def step(products):
        z = sum(p.double() @ q.double() for p, q in products) + b.double()
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = (torch.sigmoid(f) * c.double()
                 + torch.sigmoid(i) * torch.tanh(g))
        return (torch.sigmoid(o) * torch.tanh(c_new)).float(), c_new.float()

    _assert_close(step([(a_big, w_big), (a_big, w_small), (a_small, w_big)]),
                  plain, "float32")
    with pytest.raises(AssertionError):
        _assert_close(step([(a_big, w_big)]), plain, "float32")
