"""Synthesis baseline: single-pass demo encoder + program decoder.

Port of demo2program_tpu/models/synthesis.py
(`models/baselines/model_synthesis.py`): a CNN+LSTM pass over each demo,
the baseline aggregation of the k final states (avgpool, maxpool or
concat), and the LSTM program decoder: teacher-forced or, in training with
a sampling probability, scheduled sampling; decoded greedily, by beam
search or syntax-constrained (`decode_mode`). No second pass, no action or
perception heads.
"""

import functools

import torch.nn.functional as F

from demo2program_tpu_torch.dsl.karel_syntax import torch_tables
from demo2program_tpu_torch.models.common import (
    BaselineAggregation, SinglePassDemoEncoder, check_ported)
from demo2program_tpu_torch.models.decoder import TokenDecoder

_syntax_tables = functools.cache(torch_tables)


class SynthesisModel(BaselineAggregation):
    def __init__(self, cfg):
        check_ported(cfg)
        super().__init__(cfg)
        self.cfg = cfg
        self.encoder = SinglePassDemoEncoder(cfg)
        self.program_decoder = TokenDecoder(
            cfg.dim_program_token, cfg.num_lstm_cell_units,
            cfg.program_end_token, cfg.cell_impl)

    def forward(self, batch, include_greedy=True, decode_mode="greedy",
                sampling_prob=None, noise=None, decode_noise=None,
                generator=None):
        """batch: the expanded batch (ops/reconstruct.py:expand_batch).
        The keyword arguments are those of `program_outputs`."""
        _, demo_h, demo_c = self.encoder(batch["s_h"],
                                         batch["demo_len"].long())
        summary_h, summary_c = self.aggregate(demo_h, demo_c)
        return program_outputs(
            self.program_decoder, summary_c, summary_h, batch, self.cfg,
            self.training, include_greedy, decode_mode, sampling_prob, noise,
            decode_noise, generator)


def program_outputs(decoder, init_c, init_h, batch, cfg, training,
                    include_greedy, decode_mode, sampling_prob, noise,
                    decode_noise, generator):
    """The program decoder's outputs, shared by the full, synthesis and
    summarizer models (demo2program_tpu/models/synthesis.py:36-54):
    `pred_program_logits`, teacher-forced or, in training with a
    `sampling_prob`, scheduled sampling with its sampled ids as
    `pred_program_tokens` (draws `noise`, else from `generator`); with
    `include_greedy`, the `decode_program` outputs (syntax_sample draws
    `decode_noise`, else from `generator`)."""
    gt_tokens = batch["program_tokens"].long()
    out = {}
    if sampling_prob is not None and training:
        out["pred_program_logits"], out["pred_program_tokens"] = \
            decoder.scheduled(init_c, init_h, gt_tokens, sampling_prob,
                              noise, generator)
    else:
        out["pred_program_logits"] = decoder.teacher_forced(
            init_c, init_h, gt_tokens)
    if include_greedy:
        out.update(decode_program(decoder, init_c, init_h, cfg, decode_mode,
                                  decode_noise, generator))
    return out


def decode_program(decoder, init_c, init_h, cfg, decode_mode, noise=None,
                   generator=None):
    """The greedy_program_{logits,tokens,len} outputs of greedy | beam |
    syntax_greedy | syntax_sample decoding
    (demo2program_tpu/models/synthesis.py:_decode_program). Beam search
    reports one-hot indicator logits of the best beam's tokens (it has no
    per-step distribution) and the whole beam set as beam_{tokens,
    lengths,scores}, which execution reranking reads. The syntax modes run
    the Karel pushdown tables and raise on ViZDoom, as in JAX."""
    out = {}
    if decode_mode == "greedy":
        logits, tokens, lengths = decoder.greedy(init_c, init_h,
                                                 cfg.max_program_len)
    elif decode_mode == "beam":
        tokens, lengths, beams = decoder.beam(
            init_c, init_h, cfg.max_program_len, cfg.beam_width)
        logits = F.one_hot(tokens.long(), cfg.dim_program_token).float()
        out = {"beam_tokens": beams["tokens"],      # (bs, K, L)
               "beam_lengths": beams["lengths"],    # (bs, K)
               "beam_scores": beams["scores"]}      # (bs, K) log-prob sums
    elif decode_mode in ("syntax_greedy", "syntax_sample"):
        if cfg.dataset_type != "karel":
            raise NotImplementedError(
                "syntax-constrained decoding is defined for the karel DSL "
                "(matching the reference's karel-only dsl_syntax)")
        logits, tokens, lengths = decoder.greedy_constrained(
            init_c, init_h, cfg.max_program_len,
            _syntax_tables(init_c.device),
            sample=decode_mode == "syntax_sample", noise=noise,
            generator=generator)
    else:
        raise ValueError(f"unknown decode_mode {decode_mode!r}")
    out.update(greedy_program_logits=logits, greedy_program_tokens=tokens,
               greedy_program_len=lengths)
    return out
