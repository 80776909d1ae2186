"""Shared model plumbing: the config, the one- and two-pass demo encoders
and the baselines' aggregation.

Port of demo2program_tpu/models/common.py. `ModelConfig` keeps every field
and default of the JAX dataclass, so a config moves between the packages
field for field.
"""

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from demo2program_tpu_torch.models.encoder import (
    DemoEncoder, SecondPathEncoder, SummarizeFeature)
from demo2program_tpu_torch.models.ops import Dense, MeshModule
from demo2program_tpu_torch.parallel.mesh import all_gather_demos, demo_mean

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters + data dims (models/common.py:13-77)."""
    model: str = "full"
    dataset_type: str = "karel"
    batch_size: int = 32
    num_lstm_cell_units: int = 512
    demo_aggregation: str = "avgpool"
    encoder_rnn_type: str = "lstm"
    scheduled_sampling: bool = False
    scheduled_sampling_decay_steps: int = 20000
    # data dims
    dim_program_token: int = 50
    max_program_len: int = 45
    k: int = 10
    test_k: int = 5
    max_demo_len: int = 20
    h: int = 8
    w: int = 8
    depth: int = 16
    action_space: int = 6
    per_dim: int = 5
    # domain metadata
    dsl_type: str = "prob"
    env_type: Optional[str] = None
    vizdoom_pos_keys: tuple = ()
    vizdoom_max_init_pos_len: int = -1
    perception_type: str = ""
    level: Optional[str] = None
    sprite_style: str = "v2"
    program_end_token: int = 3
    # "xla" | "pallas" | "pallas_jnp": all three run the fused CUDA cell
    # here; the value tells models/convert.py which JAX layout to read
    cell_impl: str = "xla"
    beam_width: int = 5
    compute_dtype: str = "float32"
    pixel_input: bool = False
    attn_type: str = "luong"
    state_encoder_fc: bool = False
    concat_state_feature_direct_prediction: bool = False
    stack_subsequent_state: bool = False

    def __post_init__(self):
        allowed = ("lstm", "bilstm") if self.model == "induction_baseline" \
            else ("lstm",)
        if self.encoder_rnn_type not in allowed:
            # rnn/gru crash at graph build in the reference
            # (`model_full.py:243-258, 394`); bilstm is induction-only
            raise ValueError(
                f"encoder_rnn_type={self.encoder_rnn_type!r} is not "
                f"functional for model={self.model!r} (allowed: {allowed})")


def check_ported(cfg):
    """Raise ValueError for a dataset type or a compute dtype that no model
    family runs."""
    if cfg.dataset_type not in ("karel", "vizdoom"):
        raise ValueError(f"unknown dataset_type {cfg.dataset_type!r}")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute_dtype {cfg.compute_dtype!r} (allowed: "
            f"{sorted(COMPUTE_DTYPES)})")


def fold_k(x):
    """(bs, k, ...) -> (bs*k, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def unfold_k(x, bs, k):
    return x.reshape((bs, k) + tuple(x.shape[1:]))


class SinglePassDemoEncoder(nn.Module):
    """Synthesis-baseline encoder (`model_synthesis.py:322-336`): one
    CNN+LSTM pass over each of the k demos -> (feature histories, final h,
    final c), each (bs, k, ...)."""

    def __init__(self, cfg):
        super().__init__()
        self.demo_encoder = DemoEncoder(cfg.num_lstm_cell_units, cfg.h,
                                        cfg.w, cfg.depth, cfg.cell_impl,
                                        cfg.dataset_type)

    def forward(self, s_h, demo_len):
        bs, k = s_h.shape[0], s_h.shape[1]
        hist, h, c = self.demo_encoder(fold_k(s_h), fold_k(demo_len))
        return (unfold_k(hist, bs, k), unfold_k(h, bs, k),
                unfold_k(c, bs, k))


class TwoPassDemoEncoder(MeshModule):
    """Full-model and summarizer encoder (`model_full.py:367-404`): a first
    pass per demo, the mean of the final states across demos, then a second
    LSTM pass over the first-pass histories started from that summary;
    summaries of the final states by `rn_aggregation` ('rn' for the full
    model, 'rn_pure' for the summarizer). On a 2-D mesh the demos are the
    rank's k / D, and the means are over the demo group's k."""

    def __init__(self, cfg, rn_aggregation):
        super().__init__()
        units = cfg.num_lstm_cell_units
        self.demo_encoder = DemoEncoder(units, cfg.h, cfg.w, cfg.depth,
                                        cfg.cell_impl, cfg.dataset_type)
        self.second_path = SecondPathEncoder(units, cfg.cell_impl)
        self.demo_h_summary = SummarizeFeature(units, rn_aggregation)
        self.demo_c_summary = SummarizeFeature(units, rn_aggregation)

    def forward(self, s_h, demo_len):
        """s_h (bs, k, T, h, w, depth), demo_len (bs, k) int."""
        bs, k = s_h.shape[0], s_h.shape[1]
        flat_len = fold_k(demo_len)
        hist1, h1, c1 = self.demo_encoder(fold_k(s_h), flat_len)
        summary_h = demo_mean(unfold_k(h1, bs, k), self.mesh)
        summary_c = demo_mean(unfold_k(c1, bs, k), self.mesh)

        def rep(t):
            return torch.repeat_interleave(t, k, dim=0)

        hist2, h2, c2 = self.second_path(hist1, flat_len, rep(summary_c),
                                         rep(summary_h))
        demo_h = unfold_k(h2, bs, k)
        demo_c = unfold_k(c2, bs, k)
        return {
            "feature_history": unfold_k(hist2, bs, k),
            "demo_h": demo_h, "demo_c": demo_c,
            "demo_h_summary": self.demo_h_summary(demo_h),
            "demo_c_summary": self.demo_c_summary(demo_c),
        }


class BaselineAggregation(MeshModule):
    """`aggregate_baseline` (`model_synthesis.py:336-358`): the k demos'
    final (h, c) -> one (h, c), by 'avgpool' or 'maxpool' over k, or by
    'concat' of the k states projected back to `units` by two Dense layers
    (the reference's bare concat cannot start a units-wide decoder). On a
    2-D mesh avgpool is a demo-group mean, and maxpool and concat gather
    the demo group's states first.

    The synthesis and induction models derive from this class, so the two
    projections sit at the model's root, where flax puts them: the JAX
    function creates them inside the model's compact __call__."""

    def __init__(self, cfg):
        super().__init__()
        self.aggregation = cfg.demo_aggregation
        units = cfg.num_lstm_cell_units
        if self.aggregation == "concat":
            self.concat_proj_h = Dense(cfg.k * units, units)
            self.concat_proj_c = Dense(cfg.k * units, units)
        elif self.aggregation not in ("avgpool", "maxpool"):
            raise ValueError(
                f"unknown demo aggregation {self.aggregation!r}")

    def aggregate(self, demo_h, demo_c):
        """demo_h, demo_c (bs, k, units) -> (h, c), each (bs, units)."""
        if self.aggregation == "avgpool":
            return demo_mean(demo_h, self.mesh), demo_mean(demo_c, self.mesh)
        demo_h = all_gather_demos(demo_h, self.mesh)
        demo_c = all_gather_demos(demo_c, self.mesh)
        if self.aggregation == "maxpool":
            return demo_h.amax(dim=1), demo_c.amax(dim=1)
        bs = demo_h.shape[0]
        return (self.concat_proj_h(demo_h.reshape(bs, -1)),
                self.concat_proj_c(demo_c.reshape(bs, -1)))
