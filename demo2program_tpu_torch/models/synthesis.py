"""Synthesis baseline: single-pass demo encoder + program decoder.

Port of demo2program_tpu/models/synthesis.py
(`models/baselines/model_synthesis.py`): a CNN+LSTM pass over each demo,
the baseline aggregation of the k final states (avgpool, maxpool or
concat), and the LSTM program decoder, teacher-forced and greedy. No second
pass, no action or perception heads.
"""

from demo2program_tpu_torch.models.common import (
    BaselineAggregation, SinglePassDemoEncoder, check_ported)
from demo2program_tpu_torch.models.decoder import TokenDecoder


class SynthesisModel(BaselineAggregation):
    def __init__(self, cfg):
        check_ported(cfg)
        super().__init__(cfg)
        self.cfg = cfg
        self.encoder = SinglePassDemoEncoder(cfg)
        self.program_decoder = TokenDecoder(
            cfg.dim_program_token, cfg.num_lstm_cell_units,
            cfg.program_end_token, cfg.cell_impl)

    def forward(self, batch, include_greedy=True, decode_mode="greedy"):
        """batch: the expanded batch (ops/reconstruct.py:expand_batch)."""
        _, demo_h, demo_c = self.encoder(batch["s_h"],
                                         batch["demo_len"].long())
        summary_h, summary_c = self.aggregate(demo_h, demo_c)
        out = {"pred_program_logits": self.program_decoder.teacher_forced(
            summary_c, summary_h, batch["program_tokens"].long())}
        if include_greedy:
            out.update(decode_program(self.program_decoder, summary_c,
                                      summary_h, self.cfg, decode_mode))
        return out


def decode_program(decoder, init_c, init_h, cfg, decode_mode):
    """The greedy_program_{logits,tokens,len} outputs
    (demo2program_tpu/models/synthesis.py:_decode_program). Only the greedy
    branch is ported; beam and syntax-constrained decoding raise."""
    if decode_mode in ("beam", "syntax_greedy", "syntax_sample"):
        raise NotImplementedError(f"decode_mode {decode_mode!r} is not "
                                  f"ported")
    if decode_mode != "greedy":
        raise ValueError(f"unknown decode_mode {decode_mode!r}")
    logits, tokens, lengths = decoder.greedy(init_c, init_h,
                                             cfg.max_program_len)
    return {"greedy_program_logits": logits,
            "greedy_program_tokens": tokens, "greedy_program_len": lengths}
