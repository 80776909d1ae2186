"""A whole run of each cell kind at tiny sizes on the CPU, past the look
for a card: sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false, once for each fault the cell can
have (one card: no exchange between chips to leave out)."""

import pytest

from bench_torch.run import execute
from bench_torch.tests.conftest import TINY_PARAMS


def _state_unchanged(monkeypatch, after=0):
    """From update `after` on, a step returns its state unchanged."""
    from demo2program_tpu_torch.train import step

    apply = step.TrainState.apply_gradients

    def apply_gradients(self):
        if self.step < after:
            return apply(self)
        self.step += 1
        return step.global_norm([p.grad for p in self.params
                                 if p.grad is not None])
    monkeypatch.setattr(step.TrainState, "apply_gradients", apply_gradients)


def _state_unchanged_after_warmup(monkeypatch):
    """Sound through set-up, unchanged from the window on: as a step
    captured or compiled after the warm-up could be."""
    _state_unchanged(monkeypatch, after=TINY_PARAMS["warmup_steps"])


def _half_batch(monkeypatch):
    from demo2program_tpu_torch.train.device_cache import KarelDeviceCache

    batch = KarelDeviceCache.batch

    def half(self, s):
        return {k: v[:v.shape[0] // 2] for k, v in batch(self, s).items()}
    monkeypatch.setattr(KarelDeviceCache, "batch", half)


def _wrap_eval_step(monkeypatch, wrap):
    from demo2program_tpu_torch.eval import evaler

    make = evaler.make_eval_step
    monkeypatch.setattr(evaler, "make_eval_step",
                        lambda *a, **kw: wrap(make(*a, **kw)))


def _token_altered(monkeypatch):
    def wrap(step):
        def eval_step(batch):
            report, evals = step(batch)
            tokens = evals["greedy_tokens"].clone()
            tokens[0, 0] = (tokens[0, 0] + 1) % 50
            return report, dict(evals, greedy_tokens=tokens)
        return eval_step
    _wrap_eval_step(monkeypatch, wrap)


def _eval_half_batch(monkeypatch):
    def wrap(step):
        def eval_step(batch):
            report, evals = step(batch)
            half, _ = step({k: v[:v.shape[0] // 2] for k, v in batch.items()})
            return dict(report, program_loss=half["program_loss"]), evals
        return eval_step
    _wrap_eval_step(monkeypatch, wrap)


def _verdict_altered(monkeypatch):
    from demo2program_tpu_torch.eval.scorer import KarelScorer

    score = KarelScorer.score_batch

    def score_batch(self, batch, evals):
        out = score(self, batch, evals)
        seen = out["greedy_program_is_correct_execution"].copy()
        seen[0, 0] = ~seen[0, 0]
        return dict(out, greedy_program_is_correct_execution=seen)
    monkeypatch.setattr(KarelScorer, "score_batch", score_batch)


TRAIN_FAULTS = {"state_unchanged": _state_unchanged,
                "state_unchanged_after_warmup": _state_unchanged_after_warmup,
                "half_batch": _half_batch}
EVAL_FAULTS = {"token_altered": _token_altered,
               "half_batch": _eval_half_batch,
               "verdict_altered": _verdict_altered}


@pytest.mark.parametrize("cell", ["karel_full-train",
                                  "karel_synthesis-train",
                                  "karel_synthesis-eval"])
def test_sound_run_is_correct(cell, tiny_ctx):
    result, _, checks = execute(tiny_ctx(cell))
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("cell", ["karel_full-train",
                                  "karel_synthesis-train"])
def test_train_fault_is_caught(cell, fault, tiny_ctx, monkeypatch):
    TRAIN_FAULTS[fault](monkeypatch)
    result, _, checks = execute(tiny_ctx(cell))
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", sorted(EVAL_FAULTS))
def test_eval_fault_is_caught(fault, tiny_ctx, monkeypatch):
    EVAL_FAULTS[fault](monkeypatch)
    result, _, checks = execute(tiny_ctx("karel_synthesis-eval"))
    assert not result["correct"], checks


def test_changed_eval_pool_is_refused(tiny_ctx):
    ctx = tiny_ctx("karel_synthesis-eval")
    ctx.params["pool_sha256"] = "0" * 64
    with pytest.raises(ValueError, match="generator has changed"):
        execute(ctx)


def test_traced_run_reads_its_layers(tiny_ctx):
    ctx = tiny_ctx("karel_full-train", trace=1)
    result, out, _ = execute(ctx)
    # a CPU run has no device trace: only the host-clock share is read
    assert set(result["metrics"]) == {"train_step_mfu"}
    # the full model's 4T + L LSTM steps a train step
    cfg = ctx.config
    assert len(out["layer"]["lstm_calls"]) == ctx.params[
        "profile_steps"] * (4 * cfg["max_demo_len"] + cfg["max_program_len"])
