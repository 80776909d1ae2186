"""Operations and bytes of one fused LSTM step, z = [x, h] W + b and the
gate math, and the least time the card could take for it.

Operations count the matmul once, 2 B (D + H) 4H, whatever passes an
implementation makes. Bytes count x, h, c, W and b read once and h' and c'
written once."""

from bench_torch.counts import peaks

ITEMSIZE = {"float32": 4, "bfloat16": 2}


def step_ops(B, D, H):
    return 2 * B * (D + H) * 4 * H


def step_bytes(B, D, H, dtype="float32"):
    elems = B * D + 2 * B * H + (D + H) * 4 * H + 4 * H + 2 * B * H
    return elems * ITEMSIZE[dtype]


def least_time(B, D, H, dtype="float32"):
    """max(operations / peak, bytes / HBM bandwidth), in seconds."""
    return max(step_ops(B, D, H) / peaks.LSTM_PEAK[dtype],
               step_bytes(B, D, H, dtype) / peaks.HBM_BYTES)
