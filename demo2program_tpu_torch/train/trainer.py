"""The trainer, every model family (`--model`) on Karel and ViZDoom.

Port of demo2program_tpu/train/trainer.py with its device-cache loop
(`_train_chunked`, :509-575): the train split lives on the device
(train/device_cache.py: Karel's compact split, or ViZDoom's frames,
percepts and action rows) and each step gathers its batch there, so a step
copies nothing but its row indices from the host. The cadence is the JAX
package's:

  * a test-sample eval (greedy decode on the next batch of an endless
    shuffled test stream) whenever step % test_sample_step == 0, before the
    step: log line, metrics.jsonl row, decoded triplets in samples.txt;
  * the log line `[train step N] Loss: ... (sec/batch, instances/sec)` with
    the rate over the steps since the previous log line, and a
    metrics.jsonl row, whenever N % log_step == 0 and at the end;
  * a checkpoint `<train_dir>/ckpt/<N>.pt` whenever N % ckpt_save_step == 0,
    and at the end.

Relaunching into a train_dir that has checkpoints resumes from the newest
one (step, parameters, BN statistics, Adam state) and trains to the target
recorded in resume.json; batches are a pure function of (seed, step), so
the resumed run replays the uninterrupted one exactly. On the card that
needs deterministic kernels, a process-wide mode that the entry point sets
before any CUDA work (train/step.py:deterministic_cuda, which the CLIs call
first thing: cuBLAS reads CUBLAS_WORKSPACE_CONFIG at its first handle);
`Trainer` on the card raises without it. `--checkpoint` warm-starts a fresh
train_dir from a trainer checkpoint (the whole train state, as the JAX
restore does) or from a bare model state_dict.

Differences from the JAX trainer: the model is drawn with
models/ops.py:init_parameters from `--seed` (same initializers, other
numbers); the batch order follows the same rule with numpy's generator, not
jax.random (train/device_cache.py; ViZDoom's follows the JAX cache's numpy
stream); checkpoints are torch files (train/checkpoint.py). The induction
baseline trains on the test demos' actions, so its device cache keeps the
`test_*` arrays, and its test-sample evals write no program samples, as in
the JAX trainer. With `--scheduled_sampling` the draws of step s are a pure
function of (seed, s) (train/step.py:step_generator), so exact resume still
holds. ViZDoom trains from a DoomDeviceCache and samples test batches in
the full wire format, as the JAX trainer does (trainer.py:136-192); its
bs 32 -> 8 second stage is a new run with `--checkpoint` and
`--batch_size 8`. Not ported: the streaming BatchPipeline path
(a ViZDoom split that does not fit the card raises), `--sample_images`
and `--profile_steps`.
"""

import json
import os
import time

import numpy as np
import torch

from demo2program_tpu_torch.eval.evaler import (
    config_from_dataset, fetch_batch, program_vocab)
from demo2program_tpu_torch.models.ops import init_parameters
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.device_cache import (
    DoomDeviceCache, KarelDeviceCache)
from demo2program_tpu_torch.train.step import (
    TrainState, make_eval_step, make_train_step, require_deterministic_cuda,
    resolve_device, to_device)
from demo2program_tpu_torch.utils import log


class Trainer:
    def __init__(self, args, dataset_train, dataset_test, device="cuda"):
        for value, flag in ((getattr(args, "sample_images", False),
                             "--sample_images"),
                            (getattr(args, "profile_steps", 0),
                             "--profile_steps")):
            if value:
                raise NotImplementedError(f"{flag} is not ported")
        self.args = args
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_deterministic_cuda()
        self.cfg = cfg = config_from_dataset(args, dataset_train)

        hp = "bs_{}_lr_{}_{}_cell_{}".format(
            args.batch_size, args.learning_rate, args.encoder_rnn_type,
            args.num_lstm_cell_units)
        if args.scheduled_sampling:
            hp += "_sd_{}".format(args.scheduled_sampling_decay_steps)
        hp += "_k_{}".format(args.num_k)
        self.train_dir = args.train_dir or "./train_dir/{}-{}-{}-{}-{}".format(
            args.dataset_type, args.model, args.prefix, hp,
            time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(self.train_dir, exist_ok=True)
        log.infov("Train Dir: %s", self.train_dir)

        model = get_model_class(args.model)(cfg)
        init_parameters(model, torch.Generator().manual_seed(args.seed))
        self.model = model.to(self.device)
        self.state = TrainState(self.model, args.learning_rate,
                                args.lr_weight_decay)
        self.train_step = make_train_step(self.state, cfg, args.model,
                                          seed=args.seed)
        self.eval_step = make_eval_step(self.model, cfg, args.model)
        induction = args.model == "induction_baseline"
        if cfg.dataset_type == "vizdoom":
            self.cache = DoomDeviceCache(
                dataset_train, self.device, args.batch_size, args.seed,
                include_test_actions=induction)
        else:
            self.cache = KarelDeviceCache(
                dataset_train, self.device, args.batch_size, args.seed,
                include_test=induction)
        self.test_stream = _InfiniteEval(dataset_test, args.batch_size,
                                         args.seed, cfg.dataset_type)

        # auto-resume takes precedence over --checkpoint (a warm start)
        self._auto_resumed = False
        latest = checkpoint.latest_checkpoint(self.train_dir)
        if latest is not None:
            if args.checkpoint:
                log.warn("train_dir has checkpoints; auto-resuming from %s "
                         "and IGNORING --checkpoint %s", latest,
                         args.checkpoint)
            self.state.load_state_dict(checkpoint.load(latest))
            self._auto_resumed = True
            log.infov("Auto-resumed from %s (step %d; the batch sequence "
                      "replays deterministically)", latest, self.state.step)
        elif args.checkpoint:
            self.restore(args.checkpoint)

        n_params = sum(p.numel() for p in self.model.parameters())
        log.warn("total trainable parameters: %.2fM", n_params / 1e6)
        self.metrics_path = os.path.join(self.train_dir, "metrics.jsonl")
        self.samples_path = os.path.join(self.train_dir, "samples.txt")
        self.vocab = program_vocab(cfg.dataset_type, cfg.perception_type,
                                   cfg.level)

    # -- checkpointing --------------------------------------------------------
    def save(self):
        step = self.state.step
        path = checkpoint.checkpoint_path(self.train_dir, step)
        if os.path.exists(path):
            return  # already on disk (resume relaunch after a final save)
        checkpoint.save(self.state.state_dict(), path)
        log.infov("Saved checkpoint at %d", step)

    def restore(self, path):
        """Warm start from a trainer checkpoint (the whole train state) or
        a bare model state_dict (parameters and BN statistics)."""
        ckpt = checkpoint.load(path)
        if checkpoint.is_train_state(ckpt):
            self.state.load_state_dict(ckpt)
        else:
            self.model.load_state_dict(ckpt)
        log.info("Restored checkpoint from %s (step %d)", path,
                 self.state.step)

    # -- reporting -------------------------------------------------------------
    @staticmethod
    def _fetch(report):
        """0-d device tensors -> floats, in one copy to the host."""
        keys = list(report)
        values = torch.stack([report[k].float() for k in keys]).cpu()
        return dict(zip(keys, values.tolist()))

    def _log_line(self, split, step, report, step_time):
        step_time = max(step_time, 1e-3)
        log.info(
            " [%5s step %6d] Loss: %.5f (%.3f sec/batch, "
            "%.3f instances/sec)", split, step, report["loss"], step_time,
            self.args.batch_size / step_time)

    def _write_metrics(self, split, step, report):
        rec = {"split": split, "step": int(step), "time": time.time()}
        rec.update(report)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _write_samples(self, step, batch, evals, n=3):
        """Decoded (gt, pred, greedy) program triplets of a test-sample
        step, appended to samples.txt; one echoed to the log
        (demo2program_tpu/train/trainer.py:324-352). Nothing for a model
        without programs (`evals` empty: the induction baseline)."""
        if not evals:
            return
        gt_tokens = batch["program_tokens"]
        gt_len = batch["program_len"][:, 0].astype(int)
        lines = [f"# step {step}"]
        for i in range(min(n, gt_tokens.shape[0])):
            lines.append("gt    : " + self.vocab.intseq2str(
                gt_tokens[i, :gt_len[i]]))
            lines.append("pred  : " + self.vocab.intseq2str(
                evals["pred_tokens"][i, :int(evals["pred_len"][i])]))
            lines.append("greedy: " + self.vocab.intseq2str(
                evals["greedy_tokens"][i, :int(evals["greedy_len"][i])]))
        with open(self.samples_path, "a") as f:
            f.write("\n".join(lines) + "\n")
        log.info("sample @%d | gt: %s | greedy: %s", step, lines[1][8:],
                 lines[3][8:])

    def _test_sample(self):
        """One eval-mode forward with greedy decode on a test batch."""
        t1 = time.time()
        batch = next(self.test_stream)
        report, evals = self.eval_step(to_device(batch, self.device))
        report = self._fetch(report)
        step = self.state.step
        self._log_line("val", step, report, time.time() - t1)
        self._write_metrics("val", step, report)
        self._write_samples(step, batch, {k: v.cpu().numpy()
                                          for k, v in evals.items()})

    # -- loop ------------------------------------------------------------------
    def train(self, max_steps=1_000_000):
        """Train to state.step + max_steps (a resumed run: to the target in
        resume.json)."""
        args = self.args
        start = self.state.step
        resume_path = os.path.join(self.train_dir, "resume.json")
        target = start + max_steps
        if self._auto_resumed and os.path.exists(resume_path):
            with open(resume_path) as f:
                target = int(json.load(f)["target_step"])
        else:
            with open(resume_path, "w") as f:
                json.dump({"target_step": target}, f)
        if start >= target:
            log.infov("Nothing to do: step %d >= target %d", start, target)
            return
        log.infov("Training Starts! (step %d -> %d)", start, target)
        # the rate in a log line covers the steps since the previous one,
        # test-sample and checkpoint time excluded
        win_t, win_s = time.time(), start
        s = start
        while s < target:
            if s % args.test_sample_step == 0:
                self._test_sample()
                win_t, win_s = time.time(), s
            report = self.train_step(self.cache.batch(s))
            s += 1
            if s % args.log_step == 0 or s == target:
                report = self._fetch(report)
                now = time.time()
                self._log_line("train", s, report,
                               (now - win_t) / max(s - win_s, 1))
                self._write_metrics("train", s, report)
                win_t, win_s = now, s
            if s % args.ckpt_save_step == 0 and s < target:
                self.save()
                win_t, win_s = time.time(), s
        self.save()


class _InfiniteEval:
    """Endless shuffled test batches (numpy, on the host): JAX's
    _InfiniteEval over BatchPipeline(shuffle=True), compact for Karel and
    full-wire for ViZDoom, with the same id order (numpy RandomState(seed)
    reshuffles every epoch; the ragged tail is dropped)."""

    def __init__(self, dataset, batch_size, seed, dataset_type="karel"):
        if batch_size > len(dataset.ids):
            raise ValueError(f"batch_size {batch_size} exceeds the test "
                             f"split size {len(dataset.ids)}")
        self.dataset = dataset
        self.dataset_type = dataset_type
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed)
        self._id_batches = self._make_id_batches()

    def _make_id_batches(self):
        ids = list(self.dataset.ids)
        bs = self.batch_size
        while True:
            order = list(range(len(ids)))
            self.rng.shuffle(order)
            for b in range(len(order) // bs):
                yield [ids[i] for i in order[b * bs:(b + 1) * bs]]

    def __next__(self):
        return fetch_batch(self.dataset, next(self._id_batches),
                           self.dataset_type)
