"""Summarizer baseline: two-pass demo encoder + pure rn summary + program
decoder.

Port of demo2program_tpu/models/summarizer.py
(`models/baselines/model_summarizer.py`): the full model's encoder with the
PURE rn_pool aggregation (no residual mean, `model_summarizer.py:345-355`)
and only the program decoder.
"""

from torch import nn

from demo2program_tpu_torch.models.common import (
    TwoPassDemoEncoder, check_ported)
from demo2program_tpu_torch.models.decoder import TokenDecoder
from demo2program_tpu_torch.models.synthesis import decode_program


class SummarizerModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.encoder = TwoPassDemoEncoder(cfg, "rn_pure")
        self.program_decoder = TokenDecoder(
            cfg.dim_program_token, cfg.num_lstm_cell_units,
            cfg.program_end_token, cfg.cell_impl)

    def forward(self, batch, include_greedy=True, decode_mode="greedy"):
        """batch: the expanded batch (ops/reconstruct.py:expand_batch)."""
        enc = self.encoder(batch["s_h"], batch["demo_len"].long())
        c, h = enc["demo_c_summary"], enc["demo_h_summary"]
        out = {"pred_program_logits": self.program_decoder.teacher_forced(
            c, h, batch["program_tokens"].long())}
        if include_greedy:
            out.update(decode_program(self.program_decoder, c, h, self.cfg,
                                      decode_mode))
        return out
