"""Full model: two-pass summarizer encoder + multi-task heads.

Port of demo2program_tpu/models/full.py (`model_full.py`): program decoder
started from the residual rn summaries, per-demo action decoders and
perception decoders with weights shared across the k demos (k folded into
the batch). The program decoder's outputs are the synthesis baseline's
(models/synthesis.py:program_outputs): teacher-forced or scheduled
sampling, and every decode mode; the action decoder decodes greedily. The
train step skips both decoders' decoding (`include_greedy=False`). Train or
eval mode is torch's `train()` / `eval()`, the flax `train` field. The
model computes in the dtype of the parameters it is called with
(train/step.py:compute_call casts them for bf16 compute).

The "greedy" perception head is teacher-forced (`model_full.py:409`), so
the same tensor is exposed under both names.
"""

from torch import nn

from demo2program_tpu_torch.models.common import (
    TwoPassDemoEncoder, check_ported, fold_k, unfold_k)
from demo2program_tpu_torch.models.decoder import TokenDecoder, VectorDecoder
from demo2program_tpu_torch.models.synthesis import program_outputs


class FullModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        units = cfg.num_lstm_cell_units
        self.encoder = TwoPassDemoEncoder(cfg, "rn")
        self.program_decoder = TokenDecoder(
            cfg.dim_program_token, units, cfg.program_end_token,
            cfg.cell_impl)
        # <e> end token (`model_full.py:430-431`)
        self.action_decoder = TokenDecoder(
            cfg.action_space, units, cfg.action_space - 1, cfg.cell_impl)
        self.per_decoder = VectorDecoder(cfg.per_dim, units, cfg.cell_impl)

    def forward(self, batch, include_greedy=True, decode_mode="greedy",
                sampling_prob=None, noise=None, decode_noise=None,
                generator=None):
        """batch: the expanded batch (ops/reconstruct.py:expand_batch).
        The keyword arguments are those of synthesis.program_outputs."""
        cfg = self.cfg
        bs, k = batch["s_h"].shape[:2]  # k / D demos on a 2-D mesh's rank
        enc = self.encoder(batch["s_h"], batch["demo_len"].long())
        out = program_outputs(
            self.program_decoder, enc["demo_c_summary"],
            enc["demo_h_summary"], batch, cfg, self.training,
            include_greedy, decode_mode, sampling_prob, noise, decode_noise,
            generator)

        a_c = fold_k(enc["demo_c"])
        a_h = fold_k(enc["demo_h"])
        gt_actions = fold_k(batch["a_h_tokens"].long())
        act_logits = self.action_decoder.teacher_forced(a_c, a_h, gt_actions)
        out["pred_action_logits"] = unfold_k(act_logits, bs, k)

        per_logits = self.per_decoder(a_c, a_h, fold_k(batch["per"]))
        out["pred_per_logits"] = unfold_k(per_logits, bs, k)
        out["greedy_per_logits"] = out["pred_per_logits"]
        if not include_greedy:
            return out
        ga_logits, ga_tokens, ga_len = self.action_decoder.greedy(
            a_c, a_h, cfg.max_demo_len)
        out.update(greedy_action_logits=unfold_k(ga_logits, bs, k),
                   greedy_action_tokens=unfold_k(ga_tokens, bs, k),
                   greedy_action_len=unfold_k(ga_len, bs, k))
        return out
