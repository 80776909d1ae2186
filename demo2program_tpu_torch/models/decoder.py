"""Sequence decoders (program / action / perception heads).

Port of demo2program_tpu/models/decoder.py (`model_full.py:406-599`): one
LSTM layer started from the demo summary (c, h), a learned token embedding
and a bias-free output projection, with the JAX module's unroll modes:
teacher forcing, greedy, beam search, syntax-constrained greedy/sampling and
scheduled sampling, all sharing the weights of `core`.

Randomness is passed in, never taken from global state: a categorical draw
is argmax(logits + Gumbel noise) and a Bernoulli draw is uniform < p, which
is how jax.random.categorical and jax.random.bernoulli compute them, so the
JAX package's own draws fed in as `noise` reproduce its tokens. Without
`noise` the draws come from the explicit `generator` (on the model's
device). The Gumbel noise is added in the logits' dtype, in which
jax.random.categorical draws it: f32 draws are rounded to bf16 under bf16
compute.

Quirks kept:
  * the embedding has token_dim+1 rows; teacher forcing prepends the start
    id token_dim+1, which is OUT OF RANGE and embeds to ZEROS (the JAX
    package's one_hot @ table); greedy starts from the in-range id
    token_dim;
  * predicted length = first end-token position + 1, else max_len;
  * the perception head is always teacher-forced on the unshifted targets;
  * beam search: finished beams may only re-emit the end token, at no
    cost; scores are raw log-prob sums (no length normalisation), so beam
    width 1 decodes the greedy program;
  * syntax-constrained decoding: once finished, only the end token is
    legal; when every candidate is masked out, token 0 is emitted.
"""

import torch
import torch.nn.functional as F
from torch import nn

from demo2program_tpu_torch.dsl.karel_syntax import (
    POP, STACK_DEPTH, SYMBOL_MIN, initial_stack)
from demo2program_tpu_torch.models.ops import FC, Dense, make_lstm_cell

NEG = -1e9


def gumbel(shape, generator, device):
    """Standard Gumbel draws -log(-log(u)), u ~ U[tiny, 1) from `generator`
    (jax.random.gumbel's form)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def scheduled_noise(max_len, bs, vocab, generator, device):
    """The draws of one scheduled-sampling unroll: (Gumbel (L, bs, V) for
    the sampled ids, uniforms (L, bs) for the use-the-sample coin)."""
    return (gumbel((max_len, bs, vocab), generator, device),
            torch.rand((max_len, bs), generator=generator, device=device))


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
        self.output_projection = Dense(units, token_dim, bias=False)
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

    def forward(self, carry, prev_tok, gt_x=None, use_prev=None):
        """One decode step: ((c, h), prev id) -> ((c, h), logits). With
        `gt_x` (bs, E), the input is embed(prev id) where `use_prev` (bs,)
        is set and gt_x elsewhere (scheduled sampling)."""
        x = self.embed(prev_tok)
        if gt_x is not None:
            x = torch.where(use_prev[:, None], x, gt_x)
        state, out = self.cell(carry, x)
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

    def beam(self, init_c, init_h, max_len, beam_width=5):
        """Beam search (decoder.py:146-230) -> (tokens (bs, L), lengths
        (bs,)) of the best beam, plus {"tokens" (bs, K, L), "lengths" (bs,
        K), "scores" (bs, K)} of all K beams, best first.

        All K beams fold into the batch for one `core` step, so the LSTM
        runs at (bs*K) rows. Beams 1..K-1 start at -1e9 so the first step
        fans out from beam 0; each step keeps the top K of the K*V
        extensions, gathers the parents' (c, h), and the tokens are read
        back through the parent pointers at the end."""
        bs, K, V = init_c.shape[0], beam_width, self.token_dim
        dev = init_c.device
        c = init_c.repeat_interleave(K, dim=0)
        h = init_h.repeat_interleave(K, dim=0)
        prev = torch.full((bs, K), V, dtype=torch.long, device=dev)
        scores = torch.full((bs, K), NEG, device=dev)
        scores[:, 0] = 0.0
        finished = torch.zeros((bs, K), dtype=torch.bool, device=dev)
        length = torch.full((bs, K), max_len, dtype=torch.int32, device=dev)
        end_only = torch.full((V,), NEG, device=dev)
        end_only[self.end_token] = 0.0
        row0 = torch.arange(bs, device=dev)[:, None] * K
        toks, parents = [], []
        for t in range(max_len):
            (c, h), logits = self.core((c, h), prev.reshape(bs * K))
            logp = F.log_softmax(logits.reshape(bs, K, V), dim=-1)
            logp = torch.where(finished[:, :, None], end_only, logp)
            total = (scores[:, :, None] + logp).reshape(bs, K * V)
            scores, top_idx = torch.topk(total, K, dim=1)
            parent = torch.div(top_idx, V, rounding_mode="floor")
            prev = top_idx % V
            gather = (row0 + parent).reshape(-1)
            c, h = c[gather], h[gather]
            finished = finished.gather(1, parent)
            length = length.gather(1, parent)
            newly = (prev == self.end_token) & ~finished
            length = torch.where(newly, t + 1, length)
            finished = finished | newly
            toks.append(prev)
            parents.append(parent)
        beam_idx = torch.arange(K, device=dev).expand(bs, K)
        back = []
        for t in reversed(range(max_len)):
            back.append(toks[t].gather(1, beam_idx))
            beam_idx = parents[t].gather(1, beam_idx)
        all_tokens = torch.stack(back[::-1], dim=2).int()     # (bs, K, L)
        best = torch.argmax(scores, dim=1)
        rows = torch.arange(bs, device=dev)
        return (all_tokens[rows, best], length[rows, best],
                {"tokens": all_tokens, "lengths": length, "scores": scores})

    def greedy_constrained(self, init_c, init_h, max_len, syntax,
                           sample=False, noise=None, generator=None):
        """Syntax-constrained decoding (decoder.py:232-323) with the
        pushdown tables of dsl/karel_syntax.py (`torch_tables`) run on the
        device -> (logits (bs, L, V), tokens (bs, L) int32, lengths (bs,)
        int32). Each step masks the logits to the tokens legal under the
        top stack symbol whose shortest completion still fits in max_len;
        finished rows may only emit the end token; a row with every token
        masked out emits token 0. `sample=False` is syntax_greedy (masked
        argmax); `sample=True` is syntax_sample, argmax(masked + Gumbel)
        with the Gumbel draws `noise` (L, bs, V), or drawn from
        `generator`."""
        bs, V, dev = init_c.shape[0], self.token_dim, init_c.device
        if sample and noise is None:
            noise = gumbel((max_len, bs, V), generator, dev)
        init = initial_stack()
        stack = torch.zeros((bs, STACK_DEPTH), dtype=torch.long, device=dev)
        stack[:, :len(init)] = torch.tensor(init, device=dev)
        sp = torch.full((bs,), len(init), dtype=torch.long, device=dev)
        msum = torch.full((bs,), int(sum(SYMBOL_MIN[s] for s in init)),
                          dtype=torch.long, device=dev)
        end_only = F.one_hot(torch.tensor(self.end_token, device=dev),
                             V).bool()
        n_push = syntax["push_seq"].shape[-1]
        state = (init_c, init_h)
        prev = torch.full((bs,), V, dtype=torch.long, device=dev)
        finished = torch.zeros((bs,), dtype=torch.bool, device=dev)
        length = torch.full((bs,), max_len, dtype=torch.int32, device=dev)
        all_logits, all_tokens = [], []

        def read(pos):
            return stack.gather(1, pos[:, None])[:, 0]

        for t in range(max_len):
            state, logits = self.core(state, prev)
            top_pos = (sp - 1).clamp(0, STACK_DEPTH - 1)
            top = read(top_pos)
            empty = sp <= 0
            legal = syntax["legal"][top]                           # (bs, V)
            budget_ok = (t + 1 + msum[:, None]
                         + syntax["delta"][top]) <= max_len
            mask = legal & budget_ok & ~empty[:, None]
            mask = torch.where(finished[:, None], end_only, mask)
            masked = torch.where(mask, logits, NEG)
            tok = torch.argmax(
                masked + noise[t].to(masked.dtype) if sample else masked,
                dim=-1)
            tok = torch.where(mask.any(dim=-1), tok, 0)

            # the stack transition (a no-op when the token is illegal)
            do = legal.gather(1, tok[:, None])[:, 0] & ~empty & ~finished
            repl = syntax["repl"][top, tok]
            plen = syntax["push_len"][top, tok]
            msum = msum + torch.where(do, syntax["delta"][top, tok], 0)
            keep = torch.where(do & (repl != POP), repl, read(top_pos))
            stack = stack.scatter(1, top_pos[:, None], keep[:, None])
            base = torch.where(repl == POP, sp - 1, sp)
            for j in range(n_push):
                pos = (base + j).clamp(0, STACK_DEPTH - 1)
                val = torch.where(do & (j < plen),
                                  syntax["push_seq"][top, tok, j], read(pos))
                stack = stack.scatter(1, pos[:, None], val[:, None])
            sp = torch.where(do, base + plen, sp)

            newly = (tok == self.end_token) & ~finished
            length = torch.where(newly, t + 1, length)
            finished = finished | newly
            prev = tok
            all_logits.append(logits)
            all_tokens.append(tok)
        return (torch.stack(all_logits, dim=1),
                torch.stack(all_tokens, dim=1).int(), length)

    def scheduled(self, init_c, init_h, gt_tokens, sampling_prob, noise=None,
                  generator=None):
        """Scheduled-sampling unroll (decoder.py:325-355) -> (logits (bs, L,
        V), sampled ids (bs, L) int32). Step t feeds embed(previous sampled
        id) where the previous step's coin came up, else the shifted ground
        truth's embedding; the first step takes the ground truth (the
        previous id starts as 0, the coin as False). The sampled id is
        argmax(logits + Gumbel) and the coin uniform < sampling_prob, with
        `noise` = (Gumbel (L, bs, V), uniforms (L, bs)) or draws from
        `generator`. The sampled ids, not the logits' argmax, are the
        prediction the train metrics report."""
        bs, L = gt_tokens.shape
        dev = gt_tokens.device
        if noise is None:
            noise = scheduled_noise(L, bs, self.token_dim, generator, dev)
        gumbels, uniforms = noise
        gt_in = self.core.embed(self._shift_gt(gt_tokens))   # (bs, L, E)
        state = (init_c, init_h)
        prev = torch.zeros((bs,), dtype=torch.long, device=dev)
        use_prev = torch.zeros((bs,), dtype=torch.bool, device=dev)
        all_logits, all_sampled = [], []
        for t in range(L):
            state, logits = self.core(state, prev, gt_in[:, t], use_prev)
            prev = torch.argmax(
                logits.detach() + gumbels[t].to(logits.dtype), dim=-1)
            use_prev = uniforms[t] < sampling_prob
            all_logits.append(logits)
            all_sampled.append(prev)
        return (torch.stack(all_logits, dim=1),
                torch.stack(all_sampled, dim=1).int())


class VectorDecoder(nn.Module):
    """Perception-vector head (`model_full.py:564-599`): the unshifted
    target vectors through FC+BN (no activation), an LSTM, and a bias-free
    projection; always teacher-forced."""

    def __init__(self, out_dim, units, cell_impl="xla"):
        super().__init__()
        self.per_embed = FC(out_dim, units, activation="none")
        self.cell = make_lstm_cell(units, units, cell_impl)
        self.output_projection = Dense(units, out_dim, bias=False)

    def forward(self, init_c, init_h, gt_vectors):
        """gt_vectors (bs, T, out_dim) -> logits (bs, T, out_dim)."""
        x = self.per_embed(gt_vectors.float())
        _, outs = scan_cell(self.cell, (init_c, init_h), x)
        return self.output_projection(outs)
