"""The trainer, every model family (`--model`) on Karel and ViZDoom.

Port of demo2program_tpu/train/trainer.py, both of its loops in one: by
default the train split lives on the device (train/device_cache.py:
Karel's compact split, or ViZDoom's frames, percepts and action rows) and
each step gathers its batch there, so a step copies nothing but its row
indices from the host (the JAX `_train_chunked`, :509-575); with
D2P_KAREL_DEVICE_CACHE=0 / D2P_DOOM_DEVICE_CACHE=0, or a ViZDoom split
larger than the card's free memory (JAX's fallback, with its warning), a
data/pipeline.py BatchPipeline streams batches from the host instead,
copied to the card ahead of the step (the JAX streaming loop, :136-192,
448-494). The streamed train batches leave out the unseen demos, which the
step does not read (JAX's `train_drop`; the induction baseline trains on
them and keeps them), and the log's metrics rows carry `sec_data_wait`, the
seconds the step waited for its batch. The cadence is the JAX package's:

  * a test-sample eval (greedy decode on the next batch of an endless
    shuffled test stream) whenever step % test_sample_step == 0, before the
    step: log line, metrics.jsonl row, decoded triplets in samples.txt, and
    with `--sample_images` PNGs in <train_dir>/samples/ (`_write_sample_
    images`: the program heat map, and on Karel the first demo's tiles, the
    action map and the perception map);
  * the log line `[train step N] Loss: ... (sec/batch, instances/sec)` with
    the rate over the steps since the previous log line, and a
    metrics.jsonl row, whenever N % log_step == 0 and at the end;
  * a checkpoint `<train_dir>/ckpt/<N>.pt` whenever N % ckpt_save_step == 0,
    and at the end;
  * with `--profile_steps P`, a torch.profiler trace (CPU, and the card's
    kernels on cuda) of steps [start + profile_start, start + profile_start
    + P) written as a Chrome trace under <train_dir>/profile/. The JAX
    package traces its streaming loop only; here both loops honour it.
    Tracing (utils/spans.py) is on for those steps, so the trace holds the
    program's `d2p.*` spans as ranges, and the spans' summary (calls,
    inclusive and self ms a step, and the counters) is logged at its end.

Relaunching into a train_dir that has checkpoints resumes from the newest
one (step, parameters, BN statistics, Adam state) and trains to the target
recorded in resume.json; batches are a pure function of (seed, step) (a
streamed run fast-forwards its id stream by the resumed step), so the
resumed run replays the uninterrupted one exactly. On the card that needs
deterministic kernels, a process-wide mode that the entry point sets before
any CUDA work (train/step.py:deterministic_cuda, which the CLIs call first
thing: cuBLAS reads CUBLAS_WORKSPACE_CONFIG at its first handle); `Trainer`
on the card raises without it. `--checkpoint` warm-starts a fresh train_dir
from a trainer checkpoint (the whole train state, as the JAX restore does)
or from a bare model state_dict; a JAX orbax checkpoint directory is not
read (models/convert.py brings flax variables over).

Differences from the JAX trainer: the model is drawn with
models/ops.py:init_parameters from `--seed` (same initializers, other
numbers); the device cache's batch order follows the same rule with numpy's
generator, not jax.random (train/device_cache.py; ViZDoom's follows the JAX
cache's numpy stream); the streamed step s trains on the stream's draw s
(JAX spends draw 0 on initialising its state, so its step s trains on draw
s + 1); checkpoints are torch files (train/checkpoint.py); the sample demo
strip is scaled to 0..255 (JAX writes the [0, 1] floats cast to uint8). The
induction baseline trains on the test demos' actions, so its device cache
keeps the `test_*` arrays, and its test-sample evals write no program
samples, as in the JAX trainer. With `--scheduled_sampling` the draws of
step s are a pure function of (seed, s) (train/step.py:step_generator), so
exact resume still holds. ViZDoom samples test batches in the full wire
format, as the JAX trainer does; its bs 32 -> 8 second stage is a new run
with `--checkpoint` and `--batch_size 8`.

Data parallelism: under torchrun (or a caller's own process group) the
trainer builds a data mesh at init (parallel/mesh.py) over the largest
process count that divides `--batch_size`, the JAX trainer's rule and
warning (demo2program_tpu/train/trainer.py:121-131); a process left outside
that mesh takes no step. `--batch_size` is the global batch: every rank
walks the global batch stream and takes its rows (the Karel cache is
replicated, the ViZDoom cache sharded, the streamed pipeline and the test
stream make only the rank's rows), and each step computes the global
batch's update (train/step.py), so the replicas stay equal. Rank 0 alone
writes the train dir (checkpoints, resume.json, metrics.jsonl, samples.txt,
PNGs); the others wait at a barrier after each checkpoint. Every rank
resumes from the same checkpoint. The test-sample eval reports global
values, and the programs its samples need are gathered to rank 0. With
`--profile_steps` each rank writes its own trace (`..._rank<r>.json` when
the mesh has more than one rank).
"""

import json
import os
import time

import numpy as np
import torch

from demo2program_tpu_torch.data.pipeline import BatchPipeline
from demo2program_tpu_torch.envs.karel import KarelWorld, batch_to_states
from demo2program_tpu_torch.eval.evaler import (
    config_from_dataset, fetch_batch, program_vocab)
from demo2program_tpu_torch.models.ops import init_parameters
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.parallel.mesh import (
    data_axis, data_parallel_size, gather_host_rows, gather_rows, make_mesh,
    process_world, shard_rows)
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.tools.karel_render import state2image
from demo2program_tpu_torch.train.device_cache import (
    DoomDeviceCache, KarelDeviceCache, estimate_cache_bytes)
from demo2program_tpu_torch.train.step import (
    TrainState, make_eval_step, make_train_step, require_deterministic_cuda,
    to_device)
from demo2program_tpu_torch.utils import log, spans
from demo2program_tpu_torch.utils.png import write_png

# what the train step never reads, left out of a streamed train batch
# (demo2program_tpu/train/trainer.py:139-148); the induction baseline trains
# on the unseen demos' actions and keeps everything
TRAIN_DROP = {
    "karel": ("test_c_wall", "test_c_marker", "test_c_agent",
              "test_c_a_raw", "test_c_a_row_len", "test_demo_len"),
    "vizdoom": ("test_s_h", "test_a_h", "test_a_h_tokens", "test_per",
                "test_demo_len", "test_init_pos", "test_init_pos_len"),
}


def _cache_switch(dataset_type):
    """D2P_KAREL_DEVICE_CACHE / D2P_DOOM_DEVICE_CACHE: "0" streams."""
    name = {"karel": "D2P_KAREL_DEVICE_CACHE",
            "vizdoom": "D2P_DOOM_DEVICE_CACHE"}[dataset_type]
    return os.environ.get(name, "1") != "0"


class Trainer:
    def __init__(self, args, dataset_train, dataset_test, device="cuda"):
        self.args = args
        self.mesh = mesh = make_mesh(
            num_devices=data_parallel_size(args.batch_size, process_world()),
            device=device)
        self.device = mesh.device
        self.cache = self.pipe_train = None
        if not mesh.active:
            log.warn("this process is outside the %d-device mesh: it takes "
                     "no step", mesh.world)
            return
        self.writes = mesh.rank == 0  # rank 0 alone writes the train dir
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
                                          seed=args.seed, mesh=mesh)
        self.eval_step = make_eval_step(self.model, cfg, args.model,
                                        image_tensors=args.sample_images,
                                        mesh=mesh)
        induction = args.model == "induction_baseline"
        if not _cache_switch(cfg.dataset_type):
            log.info("%s device cache off: streaming the train split",
                     cfg.dataset_type)
        elif cfg.dataset_type == "karel":
            self.cache = KarelDeviceCache(
                dataset_train, self.device, args.batch_size, args.seed,
                include_test=induction, mesh=mesh)
        elif self._doom_cache_fits(dataset_train):
            self.cache = DoomDeviceCache(
                dataset_train, self.device, args.batch_size, args.seed,
                include_test_actions=induction, mesh=mesh)
        if self.cache is None:
            self.pipe_train = BatchPipeline(
                dataset_train, args.batch_size, self.device, shuffle=True,
                seed=args.seed,
                drop_keys=() if induction else TRAIN_DROP[cfg.dataset_type],
                compact=cfg.dataset_type == "karel", mesh=mesh)
        self.test_stream = _InfiniteEval(dataset_test, args.batch_size,
                                         args.seed, cfg.dataset_type, mesh)

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
            if self.pipe_train is not None:  # replay the id stream
                self.pipe_train.fast_forward(self.state.step)
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

    def _doom_cache_fits(self, dataset):
        """Does the rank's shard of the ViZDoom train split fit the card's
        free memory (JAX's est / n_dev, demo2program_tpu/train/trainer.py:
        170-184)? If not, the trainer streams, with the JAX trainer's
        warning. The CPU holds any."""
        if self.device.type != "cuda":
            return True
        est = estimate_cache_bytes(dataset) / self.mesh.world
        free, _ = torch.cuda.mem_get_info(self.device)
        if est <= free:
            return True
        log.warn("doom train split ~%.1f GB/chip exceeds the card's free "
                 "memory (%.1f GB); falling back to streaming", est / 1e9,
                 free / 1e9)
        return False

    # -- checkpointing --------------------------------------------------------
    def save(self):
        """Rank 0 writes ckpt/<step>.pt; every rank of the mesh waits for
        it at a barrier."""
        step = self.state.step
        path = checkpoint.checkpoint_path(self.train_dir, step)
        if self.writes and not os.path.exists(path):  # not on disk yet
            checkpoint.save(self.state.state_dict(), path)
            log.infov("Saved checkpoint at %d", step)
        self.mesh.barrier()

    def restore(self, path):
        """Warm start from a trainer checkpoint (the whole train state) or
        a bare model state_dict (parameters and BN statistics). A JAX
        orbax checkpoint (a directory) is not read: reading it needs orbax
        and jax, which the port never imports."""
        if os.path.isdir(path):
            raise ValueError(
                f"--checkpoint {path} is a directory (a JAX orbax "
                f"checkpoint?); the port reads its own .pt checkpoints: "
                f"bring flax variables over with models/convert.py")
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
        """The log line, rank 0's; instances/sec of the global batch."""
        if not self.writes:
            return
        step_time = max(step_time, 1e-3)
        log.info(
            " [%5s step %6d] Loss: %.5f (%.3f sec/batch, "
            "%.3f instances/sec)", split, step, report["loss"], step_time,
            self.args.batch_size / step_time)

    def _write_metrics(self, split, step, report):
        if not self.writes:
            return
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
        if self.args.sample_images:
            self._write_sample_images(step, batch, evals)

    def _write_sample_images(self, step, batch, evals):
        """PNG summaries of a test-sample step in <train_dir>/samples/
        (demo2program_tpu/train/trainer.py:354-424, the reference's image
        summaries `model_full.py:1223-1297`), from the host batch and evals:
        step_N_program.png, the gt / pred / greedy programs' one-hot rows
        (gray, 3x3 pixels a cell); on a Karel batch also step_N_demo.png,
        the first demo's states as tiles, step_N_action.png, the first
        demo's action probabilities (R) over its recorded actions (G), 8x8
        a cell, and step_N_per.png, the replayed perception vectors above
        the perception head's probabilities (gray, 8x8)."""
        out_dir = os.path.join(self.train_dir, "samples")
        os.makedirs(out_dir, exist_ok=True)
        V = self.cfg.dim_program_token
        rows = [np.eye(V, dtype=np.uint8)[batch["program_tokens"][0]].T * 255]
        for key in ("pred_tokens", "greedy_tokens"):
            if key in evals:
                rows.append(np.eye(V, dtype=np.uint8)[evals[key][0]].T * 255)
        sep = np.full((2, rows[0].shape[1]), 128, np.uint8)
        heat = np.concatenate(
            sum(([r, sep] for r in rows), [])[:-1], axis=0)
        write_png(os.path.join(out_dir, f"step_{step}_program.png"),
                  np.kron(heat, np.ones((3, 3), np.uint8)))

        if self.cfg.dataset_type != "karel" or "c_wall" not in batch:
            return
        actions = batch["c_a_raw"][0, 0]
        dlen = int(batch["demo_len"][0, 0])
        world = KarelWorld(batch_to_states(
            batch["c_wall"][0, :1], batch["c_marker"][0, :1],
            batch["c_agent"][0, :1])[0], make_error=False)
        for a in actions[:dlen - 1]:
            world.state_transition(int(a))
        strip = np.concatenate([state2image(s) for s in world.s_h], axis=1)
        write_png(os.path.join(out_dir, f"step_{step}_demo.png"),
                  (strip * 255).astype(np.uint8))

        if "pred_action_probs" in evals:
            probs = evals["pred_action_probs"][0]  # (T, A)
            T_, A_ = probs.shape
            gt_oh = np.zeros((T_, A_), np.float32)
            n_act = min(dlen - 1, T_)
            gt_oh[np.arange(n_act), actions[:n_act]] = 1.0
            if n_act < T_:
                gt_oh[n_act, A_ - 1] = 1.0  # <e>
            rgb = np.stack([probs.T, gt_oh.T, np.zeros_like(probs.T)],
                           axis=-1)
            write_png(os.path.join(out_dir, f"step_{step}_action.png"),
                      np.kron((rgb * 255).astype(np.uint8),
                              np.ones((8, 8, 1), np.uint8)))

        if "pred_per" in evals:
            gt_per = np.asarray(world.p_v_h, np.float32).T  # (P, T')
            pred = evals["pred_per"][0, 0].T  # (P, T)
            Tn = gt_per.shape[1]
            per_map = np.concatenate(
                [gt_per, np.full((1, Tn), 0.5, np.float32), pred[:, :Tn]],
                axis=0)
            write_png(os.path.join(out_dir, f"step_{step}_per.png"),
                      np.kron((per_map * 255).astype(np.uint8),
                              np.ones((8, 8), np.uint8)))

    def _test_sample(self):
        """One eval-mode forward with greedy decode on a test batch: the
        global batch's report; the samples' programs gathered to rank 0
        (the images read row 0, which is rank 0's)."""
        t1 = time.time()
        batch = next(self.test_stream)
        report, evals = self.eval_step(to_device(batch, self.device))
        report = self._fetch(report)
        step = self.state.step
        self._log_line("val", step, report, time.time() - t1)
        self._write_metrics("val", step, report)
        rows = data_axis(self.mesh)  # a row's replicas counted once
        evals = {k: gather_rows(v, rows).cpu().numpy()
                 for k, v in evals.items() if v.dim() > 0}
        programs = gather_host_rows({k: batch[k] for k in (
            "program_tokens", "program_len")}, rows)
        if self.writes:
            self._write_samples(step, dict(batch, **programs), evals)

    # -- loop ------------------------------------------------------------------
    def train(self, max_steps=1_000_000, stop_at=None):
        """Train to state.step + max_steps (a resumed run: to the target in
        resume.json). With `stop_at`, stop there if it comes first, with a
        checkpoint: a later Trainer on the train_dir resumes from it and
        goes on as the uninterrupted run would."""
        args = self.args
        if not self.mesh.active:
            return
        start = self.state.step
        resume_path = os.path.join(self.train_dir, "resume.json")
        target = start + max_steps
        if self._auto_resumed and os.path.exists(resume_path):
            with open(resume_path) as f:
                target = int(json.load(f)["target_step"])
        elif self.writes:
            with open(resume_path, "w") as f:
                json.dump({"target_step": target}, f)
        end = target if stop_at is None else min(target, stop_at)
        if start >= end:
            log.infov("Nothing to do: step %d >= target %d", start, end)
            self.close()
            return
        log.infov("Training Starts! (step %d -> %d)", start, end)
        p_start = start + args.profile_start
        p_end = p_start + args.profile_steps
        profiler = None
        # the rate in a log line covers the steps since the previous one,
        # test-sample and checkpoint time excluded
        win_t, win_s = time.time(), start
        s = start
        try:
            while s < end:
                if s % args.test_sample_step == 0:
                    self._test_sample()
                    win_t, win_s = time.time(), s
                if s == p_start < p_end:
                    profiler = self._start_profile(s)
                t0 = time.time()
                batch = (self.cache.batch(s) if self.cache is not None
                         else next(self.pipe_train))
                t_data = time.time() - t0
                report = self.train_step(batch)
                s += 1
                if profiler is not None and s == p_end:
                    profiler = self._stop_profile(profiler, p_start, s)
                if s % args.log_step == 0 or s == target:
                    report = self._fetch(report)
                    if self.pipe_train is not None:
                        report["sec_data_wait"] = t_data
                    now = time.time()
                    self._log_line("train", s, report,
                                   (now - win_t) / max(s - win_s, 1))
                    self._write_metrics("train", s, report)
                    win_t, win_s = now, s
                if s % args.ckpt_save_step == 0 and s < end:
                    self.save()
                    win_t, win_s = time.time(), s
            self.save()
        finally:
            if profiler is not None:  # the run ended inside the window
                self._stop_profile(profiler, p_start, s)
            self.close()

    def close(self):
        """Stop the streaming pipeline's worker threads (a Trainer trains
        once to its target)."""
        if self.pipe_train is not None:
            self.pipe_train.close()

    # -- profiling -------------------------------------------------------------
    def _start_profile(self, step):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        spans.reset()
        spans.enable()
        log.infov("profiler trace started at step %d", step)
        return profiler

    def _stop_profile(self, profiler, first, end):
        """Stop after the work of steps [first, end) has run on the device,
        log the spans' summary and write the Chrome trace -> None."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        spans.disable()
        profiler.stop()
        _log_spans(spans.summary(), first, end)
        out_dir = os.path.join(self.train_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        rank = f"_rank{self.mesh.rank}" if self.mesh.world > 1 else ""
        path = os.path.join(out_dir, f"trace_steps_{first}-{end}{rank}.json")
        profiler.export_chrome_trace(path)
        log.infov("profiler trace of steps [%d, %d) written to %s", first,
                  end, path)
        return None


def _log_spans(summary, first, end):
    """Log each span's calls, inclusive and self ms a step over steps
    [first, end), and the counters."""
    n = max(end - first, 1)
    log.infov("spans of steps [%d, %d), a step: calls, inclusive ms, self ms",
              first, end)
    for name, s in sorted(summary["spans"].items()):
        log.info("  %-20s %8.1f %10.3f %10.3f", name, s["calls"] / n,
                 1e3 * s["seconds"] / n, 1e3 * s["self_seconds"] / n)
    for name, v in sorted(summary["counters"].items()):
        log.info("  %-20s %d", name, v)


class _InfiniteEval:
    """Endless shuffled test batches (numpy, on the host): JAX's
    _InfiniteEval over BatchPipeline(shuffle=True), compact for Karel and
    full-wire for ViZDoom, with the same id order (numpy RandomState(seed)
    reshuffles every epoch; the ragged tail is dropped). With a data `mesh`
    every rank walks the global id stream and makes its rows only."""

    def __init__(self, dataset, batch_size, seed, dataset_type="karel",
                 mesh=None):
        if batch_size > len(dataset.ids):
            raise ValueError(f"batch_size {batch_size} exceeds the test "
                             f"split size {len(dataset.ids)}")
        self.dataset = dataset
        self.dataset_type = dataset_type
        self.batch_size = batch_size
        self.mesh = mesh
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
        ids = shard_rows(np.asarray(next(self._id_batches)), self.mesh)
        return fetch_batch(self.dataset, ids.tolist(), self.dataset_type)
