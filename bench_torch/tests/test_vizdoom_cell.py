"""The ViZDoom train cell (`vizdoom_full-train`) at tiny sizes on the CPU:
its FLOP count against torch.utils.flop_counter over the port's forward,
the encoder's least times by hand, its two metrics, a sound run correct, a
traced run's layers, planted faults and a changed pool refused, and the
TF32 control failing where the program passes."""

import math
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch.counts import peaks, vizdoom_full
from bench_torch.harness import vizdoom
from bench_torch.harness.bench import ROOT, load_cell, load_module
from bench_torch.run import execute
from bench_torch.tests.test_faults import _state_unchanged

sys.path.insert(0, str(ROOT / "bench_torch" / "tools"))
import doom_readings  # noqa: E402

CELL = "vizdoom_full-train"
# a pool of 12 programs from two generator runs of 8
TINY_POOL = {"programs": 12, "shards": 2, "per_shard": 8}


def test_forward_flops_match_flop_counter():
    from demo2program_tpu_torch.models.common import ModelConfig
    from demo2program_tpu_torch.models.full import FullModel
    from demo2program_tpu_torch.models.ops import init_parameters

    bs, k, T, L, H = 2, 3, 4, 6, 32
    mc = ModelConfig(model="full", dataset_type="vizdoom", batch_size=bs,
                     num_lstm_cell_units=H, k=k, test_k=2, max_demo_len=T,
                     max_program_len=L, h=80, w=80, depth=3,
                     dim_program_token=42, action_space=12, per_dim=6,
                     cell_impl="pallas")
    net = FullModel(mc)
    init_parameters(net, torch.Generator().manual_seed(0))
    net.train()
    g = torch.Generator().manual_seed(1)
    batch = {
        "s_h": torch.randint(0, 256, (bs, k, T, 80, 80, 3), generator=g,
                             dtype=torch.uint8),
        "demo_len": torch.full((bs, k), T - 1),
        "program_tokens": torch.randint(0, 42, (bs, L), generator=g),
        "a_h_tokens": torch.randint(0, 12, (bs, k, T), generator=g),
        "per": torch.randint(0, 2, (bs, k, T, 6), generator=g,
                             dtype=torch.uint8),
    }
    with FlopCounterMode(display=False) as fc:
        net(batch, include_greedy=False)
    cfg = dict(model="full", batch_size=bs, num_k=k, max_demo_len=T,
               max_program_len=L, num_lstm_cell_units=H,
               dim_program_token=42, action_space=12, per_dim=6, h=80, w=80,
               depth=3)
    assert vizdoom_full.forward_flops(cfg) == fc.get_total_flops()
    assert vizdoom_full.train_step_flops(cfg) == 3 * fc.get_total_flops()


def test_cell_counts_by_hand():
    _, _, cell, _, cfg = load_cell(CELL)
    cfg = dict(cfg, max_demo_len=cell["params"]["pool_T"],
               max_program_len=cell["params"]["pool_L"])
    # 80 -> 40 -> 20 -> 10 -> 5 -> 3: 2 * 9 * (40^2 16 3 + 20^2 32 16 +
    # 10^2 48 32 + 5^2 48 48 + 3^2 48 48) a frame
    per_frame = 18 * (1600 * 48 + 400 * 512 + 100 * 1536 + 25 * 2304
                      + 9 * 2304)
    assert vizdoom_full.frame_encoder_ops(1, 80, 80, 3) == per_frame
    frames = 32 * 25 * 8
    assert 5.9e10 < vizdoom_full.frame_encoder_ops(frames, 80, 80, 3) < 6e10
    least = vizdoom_full.frame_encoder_least_time(frames, 80, 80, 3)
    assert least == pytest.approx(frames * per_frame / vizdoom_full.F32_FLOPS)
    rows = 32 * 25 * 25
    assert vizdoom_full.rn_pool_ops(rows, 512) == 2 * rows * 3 * 512 * 512
    assert vizdoom_full.rn_pool_least_time(rows, 512, 32, 25) == (
        pytest.approx(vizdoom_full.rn_pool_ops(rows, 512)
                      / vizdoom_full.F32_FLOPS))
    # a byte-bound pool: few rows, the weights dominate
    assert vizdoom_full.rn_pool_least_time(4, 512, 2, 2) == pytest.approx(
        vizdoom_full.rn_pool_bytes(4, 512, 2, 2) / peaks.HBM_BYTES)
    # 0.696 TFLOP a train step at T 8, L 32
    assert 6.9e11 < vizdoom_full.train_step_flops(cfg) < 7e11


@pytest.mark.parametrize("metric", ["train.frame_encoder_roofline_share",
                                    "train.rn_pool_roofline_share"])
def test_encoder_metrics_read_their_ranges(metric):
    read = load_module("metrics", metric).read
    shapes = {"frame_shape": [80, 80, 3], "units": 512, "batch_size": 32,
              "num_k": 25}
    assert read(shapes) is None  # a program without the encoder's spans
    frames = 10 * 6400
    layer = dict(shapes, frames_calls=10, frames_count=frames,
                 frames_device_s=0.1, rn_calls=20, rn_count=20 * 20000,
                 rn_device_s=0.02)
    if "frame" in metric:
        least = 10 * vizdoom_full.frame_encoder_least_time(6400, 80, 80, 3)
        assert read(layer) == pytest.approx(100 * least / 0.1)
    else:
        least = 20 * vizdoom_full.rn_pool_least_time(20000, 512, 32, 25)
        assert read(layer) == pytest.approx(100 * least / 0.02)
    assert 0 < read(layer) < 100


@pytest.fixture
def vz_ctx(tiny_ctx, tmp_path_factory, monkeypatch):
    """tiny_ctx of the ViZDoom cell on a tiny pool, made once a pytest run
    under a temporary directory."""
    root = tmp_path_factory.getbasetemp() / "vizdoom_pool"
    monkeypatch.setattr(vizdoom, "POOL_DIR", root)

    def make(**kw):
        ctx = tiny_ctx(CELL, **kw)
        ctx.params.update(TINY_POOL)
        return ctx
    return make


def test_sound_traced_run(vz_ctx):
    ctx = vz_ctx(trace=1)
    result, out, checks = execute(ctx)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    # a CPU run has no device trace: only the host-clock share is read
    assert set(result["metrics"]) == {"train_step_mfu"}
    layer = out["layer"]
    T = ctx.config["max_demo_length"]
    split = vizdoom.load_pool(ctx.config, ctx.params, check=False)
    L = split.max_program_len
    assert split.max_demo_len <= T
    assert len(layer["lstm_calls"]) == ctx.params["profile_steps"] * (
        4 * split.max_demo_len + L)
    assert layer["flops_per_step"] == vizdoom_full.train_step_flops(dict(
        ctx.config, max_demo_len=split.max_demo_len, max_program_len=L))


def _half_batch(monkeypatch):
    from demo2program_tpu_torch.train.device_cache import DoomDeviceCache

    batch = DoomDeviceCache.batch

    def half(self, s):
        return {k: v[:v.shape[0] // 2] for k, v in batch(self, s).items()}
    monkeypatch.setattr(DoomDeviceCache, "batch", half)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_fault_is_caught(fault, vz_ctx, monkeypatch):
    {"state_unchanged": _state_unchanged, "half_batch": _half_batch}[fault](
        monkeypatch)
    result, _, checks = execute(vz_ctx())
    assert not result["correct"], checks


def test_changed_pool_is_refused(vz_ctx):
    ctx = vz_ctx()
    split = vizdoom.load_pool(ctx.config, ctx.params, check=False)
    ids, store, info = split.ids, split._store, split.info
    ctx.params.update(pool_sha256=vizdoom.digest(ids, store, info),
                      pool_T=split.max_demo_len, pool_L=split.max_program_len)
    vizdoom.load_pool(ctx.config, ctx.params)  # the right digest passes
    ctx.params["pool_sha256"] = "0" * 64
    with pytest.raises(ValueError, match="generator has changed"):
        execute(ctx)


def test_control_fails_where_the_program_passes(vz_ctx):
    ctx = vz_ctx()
    res = doom_readings.readings(ctx, ["program", "control"], 4)
    prog, ctrl = res["program"], res["control"]
    assert all(prog[k] <= ctx.limits[k] for k in ctx.limits), prog
    assert ctrl["grad_gap_median"] > 3 * max(prog["grad_gap_median"],
                                             1e-9)
    assert any(ctrl[k] > ctx.limits[k] for k in ctx.limits), ctrl


def test_cell_config_is_the_published_size():
    _, entry, cell, _, cfg = load_cell(CELL)
    assert entry["chips"] == 1 and cell["params"]["programs"] == 128
    for key, value in {"num_lstm_cell_units": 512, "batch_size": 32,
                       "num_k": 25, "test_k": 10, "max_demo_length": 8,
                       "max_program_length": 32, "h": 80, "w": 80,
                       "depth": 3, "compute_dtype": "float32",
                       "learning_rate": 1e-3, "lr_weight_decay": False,
                       "perception_type": "simple",
                       "sprite_style": "v2"}.items():
        assert cfg[key] == value, key
    from bench_torch.reference import vizdoom_model as ref
    n = sum(math.prod(s) for _, s, _ in ref.param_specs(cfg))
    assert str(f"{n:,}") in cfg["deployment"]
