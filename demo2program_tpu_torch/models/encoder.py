"""Demonstration encoders.

Port of demo2program_tpu/models/encoder.py (`model_full.py:216-277,
333-362`). The k demos are folded into the batch, as in the JAX package: one
CNN over (bs*k*T) frames and one LSTM loop over (bs*k) sequences.

dynamic_rnn length semantics kept: outputs past each sequence's length are
zeros and the final state is the one at the last valid step. The
bidirectional encoder of the induction baseline sums its two directions.
"""

import torch
from torch import nn

from demo2program_tpu_torch.models.ops import (
    Conv2D, FC, MeshModule, make_lstm_cell)
from demo2program_tpu_torch.parallel.mesh import all_gather_demos, demo_mean
from demo2program_tpu_torch.utils import spans


class StateEncoder(nn.Module):
    """Per-frame CNN (`model_full.py:216-231`): 3x3 convs, stride 2, 16/32/48
    channels for Karel grids, two more of 48 (conv4, conv5) for ViZDoom
    frames. Input (B, h, w, depth) NHWC, as in JAX; the flax SAME padding
    takes 80x80 frames to 40, 20, 10, 5 and 3, so a ViZDoom frame has
    3 * 3 * 48 = 432 features. Span `d2p.encoder.frames`; counter
    `encoder.frames`, the frames a call encodes."""

    def __init__(self, h=8, w=8, depth=16, dataset_type="karel"):
        super().__init__()
        convs = [Conv2D(depth, 16), Conv2D(16, 32), Conv2D(32, 48)]
        if dataset_type == "vizdoom":
            convs += [Conv2D(48, 48), Conv2D(48, 48)]
        for i, conv in enumerate(convs, 1):
            self.add_module(f"conv{i}", conv)
        self.n_convs = len(convs)
        for _ in convs:
            h, w = -(-h // 2), -(-w // 2)
        self.out_features = 48 * h * w

    def forward(self, s):  # (B, h, w, depth) -> (B, feat)
        with spans.span("d2p.encoder.frames"):
            spans.count("encoder.frames", s.shape[0])
            x = s.float().permute(0, 3, 1, 2)  # demos arrive as uint8
            for i in range(1, self.n_convs + 1):
                x = getattr(self, f"conv{i}")(x)
            # flatten in the JAX (NHWC) order
            return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class LSTMEncoder(nn.Module):
    """Masked LSTM over (B, T, D) with an optional initial (c, h)."""

    def __init__(self, in_features, units, cell_impl="xla"):
        super().__init__()
        self.units = units
        self.cell = make_lstm_cell(in_features, units, cell_impl)

    def forward(self, xs, seq_len, init_state=None):
        B, T, _ = xs.shape
        if init_state is None:
            zeros = xs.new_zeros(B, self.units)
            init_state = (zeros, zeros)
        c, h = init_state
        valid = (torch.arange(T, device=xs.device)[:, None]
                 < seq_len[None, :])[:, :, None]  # (T, B, 1)
        outs = []
        # time-major copy so each step's x is contiguous for the kernel
        for x, v in zip(xs.transpose(0, 1).contiguous(), valid):
            (c, h), out = _masked_step(self.cell, (c, h), x, v)
            outs.append(out)
        return torch.stack(outs, dim=1), h, c


class BiLSTMEncoder(nn.Module):
    """Bidirectional masked LSTM (`model_induction.py:435-449`): outputs
    and final states are the SUMS of the two directions. The backward
    direction reads each sequence reversed within its own length
    (tf.reverse_sequence); padded steps keep their index."""

    def __init__(self, in_features, units, cell_impl="xla"):
        super().__init__()
        self.units = units
        self.fwd = LSTMEncoder(in_features, units, cell_impl)
        self.bwd = LSTMEncoder(in_features, units, cell_impl)

    def forward(self, xs, seq_len, init_state=None):
        fwd_out, fwd_h, fwd_c = self.fwd(xs, seq_len, init_state)
        t = torch.arange(xs.shape[1], device=xs.device)[None, :]
        n = seq_len[:, None]
        rev_idx = torch.where(t < n, n - 1 - t, t)[:, :, None]  # (B, T, 1)
        xs_rev = torch.gather(xs, 1, rev_idx.expand(-1, -1, xs.shape[2]))
        bwd_out_rev, bwd_h, bwd_c = self.bwd(xs_rev, seq_len, init_state)
        bwd_out = torch.gather(bwd_out_rev, 1,
                               rev_idx.expand(-1, -1, self.units))
        return fwd_out + bwd_out, fwd_h + bwd_h, fwd_c + bwd_c


def _masked_step(cell, carry, x, v):
    """One masked LSTM step: frozen past each sequence's length.
    x (B, D), v (B, 1) validity -> ((c, h), out)."""
    c, h = carry
    (c_new, h_new), out = cell((c, h), x)
    out = torch.where(v, out, torch.zeros_like(out))
    return (torch.where(v, c_new, c), torch.where(v, h_new, h)), out


class DemoEncoder(nn.Module):
    """CNN per frame -> LSTM over time (`model_full.py:235-258`).
    Input (B, T, h, w, depth); returns (history (B, T, units), h, c)."""

    def __init__(self, units, h=8, w=8, depth=16, cell_impl="xla",
                 dataset_type="karel"):
        super().__init__()
        self.state_encoder = StateEncoder(h, w, depth, dataset_type)
        self.lstm = LSTMEncoder(self.state_encoder.out_features, units,
                                cell_impl)

    def forward(self, s_h, seq_len):
        B, T = s_h.shape[0], s_h.shape[1]
        frames = s_h.reshape((B * T,) + tuple(s_h.shape[2:]))
        feats = self.state_encoder(frames).reshape(B, T, -1)
        return self.lstm(feats, seq_len)


class SecondPathEncoder(nn.Module):
    """Second-pass LSTM over the first-pass feature history, started from
    the cross-demo summary state (`model_full.py:260-277,387-398`)."""

    def __init__(self, units, cell_impl="xla"):
        super().__init__()
        self.lstm = LSTMEncoder(units, units, cell_impl)

    def forward(self, feature_history, seq_len, summary_c, summary_h):
        return self.lstm(feature_history, seq_len,
                         init_state=(summary_c, summary_h))


class RNPool(MeshModule):
    """Relation-network pooling over the k demo features
    (`model_full.py:333-349`): all k x k pairwise concats -> 2 x FC(units,
    lrelu -> BN) -> mean over both k axes. Pair (i, j) is [feat_j, feat_i],
    flax's order. On a 2-D mesh a rank holding demos i of its slice pairs
    them with every demo j, gathered from its demo group: (k / D) x k pairs
    a rank, each pair on one rank, BatchNorm over the world's pairs and the
    mean a demo-group sum (parallel/mesh.py). Span `d2p.encoder.rn`;
    counter `encoder.rn_rows`, the pair rows a call (bs * k * K)."""

    def __init__(self, units):
        super().__init__()
        self.fc1 = FC(2 * units, units)
        self.fc2 = FC(units, units)

    def forward(self, feat):  # (bs, k, v), the rank's k of the demos
        with spans.span("d2p.encoder.rn"):
            every = all_gather_demos(feat, self.mesh)  # (bs, K, v)
            bs, k, v = feat.shape
            K = every.shape[1]
            spans.count("encoder.rn_rows", bs * k * K)
            tile1 = every[:, None, :, :].expand(bs, k, K, v)
            tile2 = feat[:, :, None, :].expand(bs, k, K, v)
            x = torch.cat([tile1, tile2], dim=3).reshape(bs * k * K, 2 * v)
            x = self.fc2(self.fc1(x))
            return demo_mean(x.reshape(bs, k, K, -1), self.mesh, dim=(1, 2))


class SummarizeFeature(MeshModule):
    """Cross-demo aggregation (`model_full.py:351-362`):
      'avgpool'  mean over k
      'rn'       mean + rn_pool (the full model)
      'rn_pure'  rn_pool only (the summarizer, `model_summarizer.py:345-355`)
    """

    def __init__(self, units, aggregation="avgpool"):
        super().__init__()
        if aggregation not in ("avgpool", "rn", "rn_pure"):
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.aggregation = aggregation
        if aggregation != "avgpool":
            self.rn_pool = RNPool(units)

    def forward(self, features):  # (bs, k, v)
        if self.aggregation == "rn_pure":
            return self.rn_pool(features)
        mean = demo_mean(features, self.mesh)
        return mean if self.aggregation == "avgpool" else (
            mean + self.rn_pool(features))
