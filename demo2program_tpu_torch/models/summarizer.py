"""Summarizer baseline: two-pass demo encoder + pure rn summary + program
decoder.

Port of demo2program_tpu/models/summarizer.py
(`models/baselines/model_summarizer.py`): the full model's encoder with the
PURE rn_pool aggregation (no residual mean, `model_summarizer.py:345-355`)
and only the program decoder, with the synthesis baseline's program
outputs (models/synthesis.py:program_outputs): scheduled sampling in
training, every decode mode.
"""

from torch import nn

from demo2program_tpu_torch.models.common import (
    TwoPassDemoEncoder, check_ported)
from demo2program_tpu_torch.models.decoder import TokenDecoder
from demo2program_tpu_torch.models.synthesis import program_outputs


class SummarizerModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.encoder = TwoPassDemoEncoder(cfg, "rn_pure")
        self.program_decoder = TokenDecoder(
            cfg.dim_program_token, cfg.num_lstm_cell_units,
            cfg.program_end_token, cfg.cell_impl)

    def forward(self, batch, include_greedy=True, decode_mode="greedy",
                sampling_prob=None, noise=None, decode_noise=None,
                generator=None):
        """batch: the expanded batch (ops/reconstruct.py:expand_batch).
        The keyword arguments are those of synthesis.program_outputs."""
        enc = self.encoder(batch["s_h"], batch["demo_len"].long())
        return program_outputs(
            self.program_decoder, enc["demo_c_summary"],
            enc["demo_h_summary"], batch, self.cfg, self.training,
            include_greedy, decode_mode, sampling_prob, noise, decode_noise,
            generator)
