"""Induction baseline: no program; predicts the action sequence of each
TEST demonstration with an LSTM that attends over the k seen demos' feature
histories.

Port of demo2program_tpu/models/induction.py
(`models/baselines/model_induction.py`):
  * state encoder: 3 convs (5 with pixel_input), optional 2 x FC(512), and
    the step's perception vector concatenated (`:399-422`);
  * demo encoder: a masked LSTM or BiLSTM over the k seen demos, optionally
    with the state features concatenated to its outputs; the final (h, c)
    aggregated by avgpool, maxpool or concat (`:524-553`);
  * the `manipulation` decoder, one per test demo (test_k folded into the
    batch): an LSTM whose input is [action embedding, previous attention],
    Luong attention against each of the k histories through ONE shared
    memory projection (`memory_layer`) and ONE shared attention layer, the
    k attention vectors averaged, and the attention (not the cell output)
    projected to action logits (`:25-53,169-171,615-667`);
  * 'luong' (masked softmax) or 'luong_monotonic' attention (`:645-656`).

Quirk kept: the decoder starts from (c, h) = (h summary, c summary), the
two SWAPPED against every other model (`:675-677`).

On a 2-D mesh (parallel/mesh.py) a rank encodes its k / D seen demos and
gathers the demo group's attention memory, keys and lengths; the test demos
are sharded on the data axis only, so the decoder runs replicated across
the demo group, as the program decoder of the other families does.
"""

import torch
from torch import nn

from demo2program_tpu_torch.models.common import (
    BaselineAggregation, check_ported, fold_k, unfold_k)
from demo2program_tpu_torch.models.decoder import embed, greedy_unroll
from demo2program_tpu_torch.models.encoder import BiLSTMEncoder, LSTMEncoder
from demo2program_tpu_torch.models.ops import (
    Conv2D, FC, Dense, make_lstm_cell, promoted)
from demo2program_tpu_torch.parallel.mesh import all_gather_demos

FC_FEATURES = 512  # the state encoder's FC width, whatever the units


class InductionStateEncoder(nn.Module):
    """CNN (+ optional FCs) with the perception vector concatenated. Input
    frames (B, h, w, depth) NHWC and percepts (B, per_dim)."""

    def __init__(self, cfg, depth):
        super().__init__()
        convs = [Conv2D(depth, 16), Conv2D(16, 32), Conv2D(32, 48)]
        if cfg.pixel_input:
            convs += [Conv2D(48, 48), Conv2D(48, 48)]
        for i, conv in enumerate(convs, 1):
            self.add_module(f"conv{i}", conv)
        self.n_convs = len(convs)
        h, w = cfg.h, cfg.w
        for _ in convs:
            h, w = -(-h // 2), -(-w // 2)
        features = 48 * h * w
        self.use_fc = cfg.state_encoder_fc
        if self.use_fc:
            self.fc1 = FC(features, FC_FEATURES)
            self.fc2 = FC(FC_FEATURES, FC_FEATURES)
            features = FC_FEATURES
        self.out_features = features + cfg.per_dim

    def forward(self, s, per):
        x = s.float().permute(0, 3, 1, 2)  # demos arrive as uint8
        for i in range(1, self.n_convs + 1):
            x = getattr(self, f"conv{i}")(x)
        # flatten in the JAX (NHWC) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if self.use_fc:
            x = self.fc2(self.fc1(x))
        return torch.cat([x, per.float()], dim=-1)


class InductionDemoEncoder(nn.Module):
    """Frames (B, T, h, w, depth), percepts (B, T, per_dim) -> (history
    (B, T, out_features), h, c)."""

    def __init__(self, cfg, depth):
        super().__init__()
        self.state_encoder = InductionStateEncoder(cfg, depth)
        features = self.state_encoder.out_features
        rnn = BiLSTMEncoder if cfg.encoder_rnn_type == "bilstm" \
            else LSTMEncoder
        self.lstm = rnn(features, cfg.num_lstm_cell_units, cfg.cell_impl)
        self.concat_features = cfg.concat_state_feature_direct_prediction
        self.out_features = cfg.num_lstm_cell_units + (
            features if self.concat_features else 0)

    def forward(self, s_h, per, seq_len):
        B, T = s_h.shape[0], s_h.shape[1]
        frames = s_h.reshape((B * T,) + tuple(s_h.shape[2:]))
        feats = self.state_encoder(frames, per.reshape(B * T, -1))
        feats = feats.reshape(B, T, -1)
        outs, h, c = self.lstm(feats, seq_len)
        if self.concat_features:
            outs = torch.cat([outs, feats], dim=-1)
        return outs, h, c


def monotonic_alignment(scores, mask, prev_align):
    """Monotonic attention in TF's parallel form (LuongMonotonicAttention,
    `model_induction.py:649-651`), over the last axis:

        p     = sigmoid(score)
        cp    = exclusive cumprod(1 - p)
        align = p * cp * cumsum(prev_align / clip(cp, 1e-10, 1))
    """
    p = torch.sigmoid(scores)
    one_minus = torch.where(mask, 1.0 - p, torch.ones_like(p))
    cp = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]),
                                  one_minus[..., :-1]], dim=-1), dim=-1)
    # jnp.clip is maximum, then minimum; torch's maximum and minimum split
    # the gradient at a tie as JAX's do (cp == 1 is common), torch.clamp
    # would pass all of it
    clipped = torch.minimum(torch.maximum(cp, cp.new_tensor(1e-10)),
                            cp.new_tensor(1.0))
    align = p * cp * torch.cumsum(prev_align / clipped, dim=-1)
    return torch.where(mask, align, torch.zeros_like(align))


class AttnDecoderCore(nn.Module):
    """One attention-decoder step (the JAX `_AttnDecoderCore`, module
    `manipulation`): embedding of action_space+1 rows, an LSTM cell over
    [embedding, previous attention] (2 * units), the shared attention layer
    and a bias-free output projection."""

    def __init__(self, action_space, units, memory_features, cell_impl,
                 attn_type):
        super().__init__()
        self.attn_type = attn_type
        self.embedding = nn.Parameter(torch.empty(action_space + 1, units))
        self.cell = make_lstm_cell(2 * units, units, cell_impl)
        self.attention_layer = Dense(units + memory_features, units,
                                         bias=False)
        self.output_projection = Dense(units, action_space, bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # flax uniform(scale=0.02): U[0, 0.02)
        nn.init.uniform_(self.embedding, 0.0, 0.02, generator=generator)

    def forward(self, carry, x_emb, memory, keys, mask):
        """carry ((c, h), attention (B, units), alignments (B, k, T)),
        x_emb (B, units), memory (B, k, T, M), keys (B, k, T, units), mask
        (B, k, T) -> (carry, logits (B, action_space))."""
        (c, h), attention, prev_align = carry
        (c, h), out = self.cell((c, h), torch.cat([x_emb, attention], -1))
        # jnp.einsum promotes its operands (a bf16 cell output against f32
        # keys when the memory holds the f32 state features)
        dtype = promoted(out, keys)
        scores = torch.einsum("bu,bktu->bkt", out.to(dtype), keys.to(dtype))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
        if self.attn_type == "luong_monotonic":
            align = monotonic_alignment(scores, mask, prev_align)
        else:
            align = torch.softmax(scores, dim=-1)
        dtype = promoted(align, memory)
        ctx = torch.einsum("bkt,bktm->bkm", align.to(dtype),
                           memory.to(dtype))
        out_k = out[:, None, :].expand(-1, memory.shape[1], -1)
        attention = self.attention_layer(
            torch.cat([out_k, ctx], dim=-1)).mean(dim=1)
        return ((c, h), attention, align), self.output_projection(attention)


class InductionModel(BaselineAggregation):
    def __init__(self, cfg):
        check_ported(cfg)
        if cfg.attn_type not in ("luong", "luong_monotonic"):
            raise ValueError(f"unknown attn_type {cfg.attn_type!r}")
        super().__init__(cfg)
        self.cfg = cfg
        units = cfg.num_lstm_cell_units
        depth = cfg.depth * (2 if cfg.stack_subsequent_state else 1)
        self.encoder = InductionDemoEncoder(cfg, depth)
        memory_features = self.encoder.out_features
        self.memory_layer = Dense(memory_features, units, bias=False)
        self.manipulation = AttnDecoderCore(
            cfg.action_space, units, memory_features, cfg.cell_impl,
            cfg.attn_type)

    def forward(self, batch, include_greedy=True, sampling_prob=None,
                noise=None, generator=None):
        """batch: the expanded batch with the test demos' actions
        (`test_a_h_tokens`) -> pred_action_logits (bs, test_k, T, A) and,
        with include_greedy, greedy_action_{logits,tokens,len}. Scheduled
        sampling (`sampling_prob`, `noise`, `generator`) is accepted and
        ignored, as in the JAX module
        (demo2program_tpu/models/induction.py:159-160)."""
        cfg = self.cfg
        bs, k = batch["s_h"].shape[:2]  # k / D demos on a 2-D mesh's rank
        test_k = cfg.test_k
        s_h, per = batch["s_h"], batch["per"]
        demo_len = batch["demo_len"].long()
        if cfg.stack_subsequent_state:
            # consecutive state PAIRS on the channel axis
            # (`model_induction.py:385-396`); the percepts follow the first
            # state of each pair, as in the JAX module
            s_h = torch.cat([s_h[:, :, :-1], s_h[:, :, 1:]], dim=-1)
            per = per[:, :, :-1]
            demo_len = demo_len - 1

        hist, h, c = self.encoder(fold_k(s_h), fold_k(per),
                                  fold_k(demo_len))
        memory = unfold_k(hist, bs, k)  # (bs, k, T, M)
        h_sum, c_sum = self.aggregate(unfold_k(h, bs, k),
                                      unfold_k(c, bs, k))
        keys = self.memory_layer(memory)  # one matmul for every step
        # every seen demo of the task (the demo group's, on a 2-D mesh)
        memory, keys, demo_len = (all_gather_demos(t, self.mesh)
                                  for t in (memory, keys, demo_len))
        k, T = memory.shape[1], memory.shape[2]
        mask = (torch.arange(T, device=memory.device)[None, None, :]
                < demo_len[:, :, None])  # (bs, k, T)

        # test_k folded into the batch: each test demo decodes on its own
        def rep(x):
            return torch.repeat_interleave(x, test_k, dim=0)

        mem_r, keys_r, mask_r = rep(memory), rep(keys), rep(mask)
        n = bs * test_k
        align0 = memory.new_zeros(n, k, T)
        align0[:, :, 0] = 1.0  # monotonic attention starts at position 0
        # QUIRK: c <- the h summary, h <- the c summary
        carry0 = ((rep(h_sum), rep(c_sum)),
                  memory.new_zeros(n, cfg.num_lstm_cell_units), align0)
        core = self.manipulation

        def step(carry, ids):
            return core(carry, embed(core.embedding, ids), mem_r, keys_r,
                        mask_r)

        # teacher forcing from the out-of-range start id action_space + 1,
        # which embeds to zeros
        gt = fold_k(batch["test_a_h_tokens"].long())  # (n, T_a)
        gt_in = torch.cat([torch.full_like(gt[:, :1], cfg.action_space + 1),
                           gt[:, :-1]], dim=1)
        carry, logits = carry0, []
        for ids in gt_in.t():
            carry, step_logits = step(carry, ids)
            logits.append(step_logits)
        out = {"pred_action_logits": unfold_k(torch.stack(logits, dim=1),
                                              bs, test_k)}
        if include_greedy:
            # from the in-range id action_space, ending at <e>, for as many
            # steps as the test demos' action rows
            start = torch.full((n,), cfg.action_space, dtype=torch.long,
                               device=gt.device)
            g_logits, g_tokens, g_len = greedy_unroll(
                step, carry0, start, cfg.action_space - 1, gt.shape[1])
            out.update(greedy_action_logits=unfold_k(g_logits, bs, test_k),
                       greedy_action_tokens=unfold_k(g_tokens, bs, test_k),
                       greedy_action_len=unfold_k(g_len, bs, test_k))
        return out
