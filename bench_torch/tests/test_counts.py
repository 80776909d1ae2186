"""The counting functions against hand computation and against
torch.utils.flop_counter over the program's plain forward."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch.counts import lstm, model_flops, peaks
from bench_torch.harness.bench import load_cell


def test_lstm_step_counts_by_hand():
    B, D, H = 320, 512, 512
    assert lstm.step_ops(B, D, H) == 2 * 320 * 1024 * 2048 == 1342177280
    # x, h, c (B, 512); W (1024, 2048); b (2048); h', c' (B, 512), f32
    elems = 320 * 512 * 3 + 1024 * 2048 + 2048 + 320 * 512 * 2
    assert lstm.step_bytes(B, D, H) == 4 * elems
    assert lstm.step_bytes(B, D, H, "bfloat16") == 2 * elems
    least = lstm.least_time(B, D, H)
    assert least == pytest.approx(4 * elems / peaks.HBM_BYTES)
    assert least > lstm.step_ops(B, D, H) / peaks.TF32_FLOPS


TINY = dict(k=3, test_k=2, T=6, L=12, units=64, bs=8)


@pytest.mark.parametrize("model", ["full", "synthesis_baseline"])
def test_forward_flops_match_flop_counter(model):
    from demo2program_tpu_torch.models.common import ModelConfig
    from demo2program_tpu_torch.models.ops import init_parameters
    from demo2program_tpu_torch.models.registry import get_model_class

    t = TINY
    mc = ModelConfig(model=model, batch_size=t["bs"],
                     num_lstm_cell_units=t["units"], k=t["k"],
                     test_k=t["test_k"], max_demo_len=t["T"],
                     max_program_len=t["L"], cell_impl="pallas")
    net = get_model_class(model)(mc)
    init_parameters(net, torch.Generator().manual_seed(0))
    net.train()
    g = torch.Generator().manual_seed(1)
    bs, k, T, L = t["bs"], t["k"], t["T"], t["L"]
    batch = {
        "s_h": torch.rand(bs, k, T, 8, 8, 16, generator=g),
        "demo_len": torch.full((bs, k), T - 1),
        "program_tokens": torch.randint(0, 50, (bs, L), generator=g),
        "a_h_tokens": torch.randint(0, 6, (bs, k, T), generator=g),
        "per": torch.rand(bs, k, T, 5, generator=g),
    }
    with FlopCounterMode(display=False) as fc:
        net(batch, include_greedy=False)
    cfg = dict(model=model, batch_size=bs, num_k=k, max_demo_len=T,
               max_program_len=L, num_lstm_cell_units=t["units"],
               dim_program_token=50, action_space=6, per_dim=5, h=8, w=8,
               depth=16)
    assert model_flops.forward_flops(cfg) == fc.get_total_flops()
    assert model_flops.train_step_flops(cfg) == 3 * fc.get_total_flops()


@pytest.mark.parametrize("cell", ["karel_full-train", "karel_synthesis-train"])
def test_train_step_flops_of_the_cells(cell):
    _, _, _, _, cfg = load_cell(cell)
    flops = model_flops.train_step_flops(cfg)
    # 101 GFLOP of LSTM matmuls a full-model forward at these shapes
    assert 2e10 < flops < 4e11
