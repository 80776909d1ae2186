"""The benchmark's plain ViZDoom reference (bench_torch/reference/
vizdoom_model.py) against the port's full model, on the CPU at a tiny size
(units 16, bs 4, k 3, 80x80x3 DoomLite frames of a tiny generated split),
through the benchmark's own ViZDoom train driver: the loss, every leaf's
first gradient and three Adam steps agree; the TF32 control, and the port
with a planted fault, do not. Also the encoder's spans and counters on a
ViZDoom train step.

The driver's numbers (traffic/train_cache.py:gaps): `loss_gap`, the widest
relative gap of a step's loss; `grad_gap_median`, the median leaf's gap of
the first clipped gradient's norm; `change_gap`, the worst leaf's gap of
the change over the steps, without what moves by rounding alone under
Adam. Sound runs read under a third of TOL (seeds tried: 5, 99 and the
one here), the TF32 control 2.3x-5.7x TOL's `loss_gap` and over 16x its
`grad_gap_median`.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_torch.harness import vizdoom
from bench_torch.harness.bench import ROOT, Context, load_module
from bench_torch.reference import vizdoom_model as ref
from demo2program_tpu_torch.data.vizdoom_generator import (
    VizdoomGeneratorConfig)
from demo2program_tpu_torch.data.vizdoom_memory import generate_split
from demo2program_tpu_torch.models import encoder
from demo2program_tpu_torch.ops import reconstruct
from demo2program_tpu_torch.utils import spans

BS, K, UNITS, STEPS = 4, 3, 16, 3
GEN = VizdoomGeneratorConfig(num_train=8, num_test=0, num_val=0, seed=3,
                             num_demo_per_program=K,
                             num_test_demo_per_program=2)
TINY = {"num_lstm_cell_units": UNITS, "batch_size": BS, "num_k": K,
        "test_k": 2}
TOL = {"loss_gap": 1e-5, "grad_gap_median": 1e-5, "change_gap": 1e-2}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split():
    return generate_split(GEN)


@pytest.fixture
def driver(split, monkeypatch):
    """-> (the ViZDoom train driver, a tiny Context of its cell) on the
    tiny split."""
    monkeypatch.setattr(vizdoom, "load_pool", lambda cfg, p, check: split)
    ctx = Context("vizdoom_full-train", 2 ** 40 + 17, 1.0, 0, "cpu",
                  config_override=TINY)
    return load_module("traffic", "doom_train_cache"), ctx


def _program(driver):
    """STEPS of the port's Trainer from the benchmark's weights -> (its
    split, the reference's configuration, the stretch's readings, each
    leaf's first clipped gradient as Adam got it)."""
    dc, ctx = driver
    split, trainer, names, cfg = dc.setup(ctx)
    opt = trainer.state.optimizer
    params = dict(trainer.model.named_parameters())
    grads, step = {}, opt.step

    def first_step(*a, **kw):
        if not grads:
            grads.update({n: params[n].grad.detach().clone() for n in names})
        return step(*a, **kw)
    opt.step = first_step
    return split, cfg, dc.steps(trainer, names, 0, STEPS), grads


def _gaps(dc, cfg, split, stretch, ar=None):
    r = dc.reference(cfg, split, stretch, ref.Arith(), "cpu")
    if ar is None:
        return dc.tc.gaps(*stretch[2:], *r), r
    c = dc.reference(cfg, split, stretch, ar, "cpu")
    return dc.tc.gaps(*c[:3], *r), r


def test_reference_matches_the_port(driver):
    """Loss, every leaf's first clipped gradient, and the change of three
    Adam steps: the port's Trainer against the plain reference."""
    dc = driver[0]
    split, cfg, stretch, grads = _program(driver)
    gaps, r = _gaps(dc, cfg, split, stretch)
    for k, tol in TOL.items():
        assert gaps[k] <= tol, (k, gaps[k])
    r_grad = r[3]
    med = float(np.median([float(g.norm()) for g in r_grad.values()]))
    for n, g in r_grad.items():
        gap = float((grads[n] - g).norm()) / max(float(g.norm()), med)
        assert gap < 1e-4, (n, gap)
    assert len(r_grad) == len(ref.param_specs(cfg)) == len(grads)


def test_tf32_control_fails(driver):
    """The reference in TF32 against itself in float32 fails TOL, where
    the port passes it."""
    dc = driver[0]
    split, cfg, stretch, _ = _program(driver)
    control, _ = _gaps(dc, cfg, split, stretch, ref.Arith(True))
    assert control["loss_gap"] > TOL["loss_gap"], control
    assert control["grad_gap_median"] > 3 * TOL["grad_gap_median"], control


def _conv5_dropped(monkeypatch):
    """conv5 skipped: conv4's 5x5 output subsampled to 3x3 in its place."""
    def forward(self, s):
        x = s.float().permute(0, 3, 1, 2)
        for i in range(1, self.n_convs):
            x = getattr(self, f"conv{i}")(x)
        x = x[:, :, ::2, ::2]
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    monkeypatch.setattr(encoder.StateEncoder, "forward", forward)


def _action_quirk_dropped(monkeypatch):
    """The end token at each demo's own length, not at the item's widest
    action row."""
    expand = reconstruct.expand_doom_batch

    def expand_doom_batch(batch, cfg):
        out = expand(batch, cfg)
        T = out["a_h"].shape[2]
        t = torch.arange(T)[None, None, :]
        n = batch["demo_len"].long()[..., None] - 1
        tok = torch.where(t < n, batch["c_a_raw"].long(),
                          torch.where(t == n, cfg.action_space - 1, 0))
        onehot = torch.nn.functional.one_hot(tok, cfg.action_space).float()
        onehot = onehot * (t <= n)[..., None]
        return dict(out, a_h=onehot,
                    a_h_tokens=onehot.argmax(-1).int())
    monkeypatch.setattr(reconstruct, "expand_doom_batch", expand_doom_batch)


def _rn_self_pairs(monkeypatch):
    """Each demo paired with itself only: k pairs [feat_i, feat_i] in place
    of the k x k. (Swapping a pair's halves is no fault: every pair and its
    mirror both enter, and batch norm and the mean see no order.)"""
    def forward(self, feat):
        bs, k, v = feat.shape
        x = torch.cat([feat, feat], dim=2).reshape(bs * k, 2 * v)
        return self.fc2(self.fc1(x)).reshape(bs, k, -1).mean(dim=1)
    monkeypatch.setattr(encoder.RNPool, "forward", forward)


FAULTS = {"conv5_dropped": _conv5_dropped,
          "action_quirk_dropped": _action_quirk_dropped,
          "rn_self_pairs": _rn_self_pairs}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_caught(fault, driver, monkeypatch):
    FAULTS[fault](monkeypatch)
    dc = driver[0]
    split, cfg, stretch, _ = _program(driver)
    gaps, _ = _gaps(dc, cfg, split, stretch)
    assert any(gaps[k] > 3 * tol for k, tol in TOL.items()), gaps


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; import bench_torch.reference.vizdoom_model; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('demo2program_tpu', 'demo2program_tpu_torch', 'jax', "
            "'flax', 'optax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


# -- the encoder's spans and counters ----------------------------------------

def _two_steps(driver, traced):
    dc, ctx = driver
    torch.manual_seed(0)
    split, trainer, names, cfg = dc.setup(ctx)
    if traced:
        spans.enable()
    try:
        reports = [trainer.train_step(trainer.cache.batch(s))
                   for s in range(2)]
    finally:
        spans.disable()
    return trainer.model, reports, cfg


def test_encoder_spans_and_counters(driver):
    """Two ViZDoom train steps: off, no event and no counter; on, the
    frame CNN's span once a forward and the RN pool's twice (the h and c
    summaries), `encoder.frames` B * T a call (B = bs * k demos) and
    `encoder.rn_rows` bs * k * k a call; parameters and reports the same
    on and off."""
    model_off, reports_off, cfg = _two_steps(driver, False)
    assert spans.summary() == {"spans": {}, "counters": {}}
    model_on, reports_on, _ = _two_steps(driver, True)
    for (k, a), b in zip(model_off.state_dict().items(),
                         model_on.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(reports_off, reports_on):
        assert all(torch.equal(a[k], b[k]) for k in a)
    got = spans.summary()
    assert got["spans"]["d2p.encoder.frames"]["calls"] == 2
    assert got["spans"]["d2p.encoder.rn"]["calls"] == 4
    T = cfg["max_demo_len"]
    assert got["counters"]["encoder.frames"] == 2 * BS * K * T
    assert got["counters"]["encoder.rn_rows"] == 4 * BS * K * K
    forwards = {e[0] for e in spans._events if e[2] == "d2p.train.forward"}
    for _, parent, name, _, _, _ in spans._events:
        if name.startswith("d2p.encoder."):
            assert parent in forwards, name
