"""Sequence decoders (program / action / perception heads).

Port of demo2program_tpu/models/decoder.py (`model_full.py:406-599`): one
LSTM layer started from the demo summary (c, h), a learned token embedding
and a bias-free output projection. This slice ports teacher forcing and
greedy decoding; beam, syntax-constrained and scheduled sampling wait.

Quirks kept:
  * the embedding has token_dim+1 rows; teacher forcing prepends the start
    id token_dim+1, which is OUT OF RANGE and embeds to ZEROS (the JAX
    package's one_hot @ table); greedy starts from the in-range id
    token_dim;
  * predicted length = first end-token position + 1, else max_len;
  * the perception head is always teacher-forced on the unshifted targets.
"""

import torch
from torch import nn

from demo2program_tpu_torch.models.ops import FC, make_lstm_cell


def embed(table, ids):
    """ids (...) int -> (..., E) rows of `table` (N, E); ids outside
    [0, N) embed to zeros, like the JAX package's one_hot(ids, N) @ table."""
    n = table.shape[0]
    valid = (ids >= 0) & (ids < n)
    rows = table[ids.clamp(0, n - 1)]
    return rows * valid[..., None].to(rows.dtype)


def greedy_unroll(step, carry, start, end_token, max_len):
    """Greedy decoding for max_len steps: `step(carry, prev ids) -> (carry,
    logits)`, from the ids `start` (bs,) -> (logits (bs, L, V), tokens (bs,
    L) int32, lengths (bs,) int32). Every step runs; the length is where the
    end token first appears + 1, else max_len."""
    prev = start
    finished = torch.zeros_like(start, dtype=torch.bool)
    length = torch.full_like(start, max_len, dtype=torch.int32)
    all_logits, all_tokens = [], []
    for t in range(max_len):
        carry, logits = step(carry, prev)
        prev = torch.argmax(logits, dim=-1)
        newly = (prev == end_token) & ~finished
        length = torch.where(newly, t + 1, length)
        finished = finished | newly
        all_logits.append(logits)
        all_tokens.append(prev)
    return (torch.stack(all_logits, dim=1),
            torch.stack(all_tokens, dim=1).int(), length)


def scan_cell(cell, carry, xs):
    """Unmasked LSTM over xs (B, T, D) from carry (c, h).
    Returns (carry, outputs (B, T, H))."""
    outs = []
    # time-major copy so each step's x is contiguous for the kernel
    for x in xs.transpose(0, 1).contiguous():
        carry, out = cell(carry, x)
        outs.append(out)
    return carry, torch.stack(outs, dim=1)


class _DecoderCore(nn.Module):
    """Embedding + LSTM cell + projection."""

    def __init__(self, token_dim, units, cell_impl="xla"):
        super().__init__()
        self.token_dim = token_dim
        self.embedding = nn.Parameter(torch.empty(token_dim + 1, units))
        self.cell = make_lstm_cell(units, units, cell_impl)
        self.output_projection = nn.Linear(units, token_dim, bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # flax uniform(scale=0.02): U[0, 0.02)
        nn.init.uniform_(self.embedding, 0.0, 0.02, generator=generator)

    def embed(self, ids):
        return embed(self.embedding, ids)

    def run_tf(self, init_c, init_h, input_ids):
        """Teacher-forced unroll over known input ids (bs, L)."""
        _, outs = scan_cell(self.cell, (init_c, init_h),
                            self.embed(input_ids))
        return self.output_projection(outs)

    def forward(self, carry, prev_tok):
        """One greedy decode step: ((c, h), prev id) -> ((c, h), logits)."""
        state, out = self.cell(carry, self.embed(prev_tok))
        return state, self.output_projection(out)


class TokenDecoder(nn.Module):
    """LSTM token decoder; the unroll modes share the weights of `core`."""

    def __init__(self, token_dim, units, end_token, cell_impl="xla"):
        super().__init__()
        self.token_dim = token_dim
        self.end_token = end_token
        self.core = _DecoderCore(token_dim, units, cell_impl)

    def _shift_gt(self, gt_tokens):
        start = torch.full((gt_tokens.shape[0], 1), self.token_dim + 1,
                           dtype=gt_tokens.dtype, device=gt_tokens.device)
        return torch.cat([start, gt_tokens[:, :-1]], dim=1)

    def teacher_forced(self, init_c, init_h, gt_tokens):
        """gt_tokens (bs, L) -> logits (bs, L, token_dim)."""
        return self.core.run_tf(init_c, init_h, self._shift_gt(gt_tokens))

    def greedy(self, init_c, init_h, max_len):
        """-> (logits (bs, L, V), tokens (bs, L) int32, lengths (bs,) int32).
        Decoding runs all max_len steps; the length is where the end token
        first appears."""
        start = torch.full((init_c.shape[0],), self.token_dim,
                           dtype=torch.long, device=init_c.device)
        return greedy_unroll(self.core, (init_c, init_h), start,
                             self.end_token, max_len)


class VectorDecoder(nn.Module):
    """Perception-vector head (`model_full.py:564-599`): the unshifted
    target vectors through FC+BN (no activation), an LSTM, and a bias-free
    projection; always teacher-forced."""

    def __init__(self, out_dim, units, cell_impl="xla"):
        super().__init__()
        self.per_embed = FC(out_dim, units, activation="none")
        self.cell = make_lstm_cell(units, units, cell_impl)
        self.output_projection = nn.Linear(units, out_dim, bias=False)

    def forward(self, init_c, init_h, gt_vectors):
        """gt_vectors (bs, T, out_dim) -> logits (bs, T, out_dim)."""
        x = self.per_embed(gt_vectors.float())
        _, outs = scan_cell(self.cell, (init_c, init_h), x)
        return self.output_projection(outs)
