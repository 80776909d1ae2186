#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; exits non-zero
without them. It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the fused LSTM kernel from demo2program_tpu_torch/csrc with nvcc
     for sm_90a, prints the build time and ptxas's registers, shared memory
     and spills for every kernel instance, and checks that none spills;
  3. kernel phase: holds the kernel against its plain PyTorch version on the
     card at every shape of the full model's path (D in {48, 512},
     H = 512, B in {32, 320}), at beam search's (160, 512), at the two
     only the induction baseline runs ((B, D) = (320, 53) and (160,
     1024)) and at ViZDoom's (800, 432) and (800, 512) (bs 32 x k 25 rows;
     432 = the 5-conv encoder's 3 x 3 x 48 features), f32 and bf16, prints
     each launch's grid, block count and load path (`vec`: 16-byte async
     copies or plain loads), and times both versions three ways:
     back-to-back calls from Python (host-paced, `ms`), 50 calls captured
     in a CUDA graph and replayed (device time, `device_ms`), and the
     host's own time per call (`host_us`); times torch.lstm_cell the same
     way (`library_device_ms`) and computes the bound (`bound_ms`);
  4. slice phase: makes a seeded in-memory Karel split (k=10, test_k=5,
     T=20, L=45), saves a random-init FullModel at 512 units as a .pt,
     evaluates 3 batches of 32 through the port's Evaler with
     --checkpoint, checks that every LSTM step of the run went through the
     kernel (5*T + 2*L launches per batch), that the report is finite, that
     the model on the card agrees with the plain CPU path on a small batch,
     and that the ground-truth programs score execution 1.0 on the seen
     and the unseen demos (replay + VM on the card); then times one eval
     forward with the kernel against one with the plain LSTM step;
  5. train phase: builds the port's Trainer through trainer_cli's parser
     (--device cuda, units 512, bs 32, k=10, cell_impl pallas) on the same
     split and trains 30 steps (log every 10, one test-sample eval,
     checkpoint at 30); checks that every forward LSTM step went through
     the kernel (30 x (4*T + L) + 190 per test-sample eval), that the loss
     is finite and its mean over the last log window is below the first
     window's; compares one step's loss, grad norm and every gradient on
     the card (kernel forward, recomputing backward) with the CPU (plain)
     and with the card's plain step under autograd; evaluates the final
     checkpoint through the Evaler (3 batches, 190 launches each); times
     forward, backward and optimizer of a step with the kernel against the
     plain step, in turns;
  6. baselines phase: the same for synthesis_baseline, summarizer and
     induction_baseline (lstm encoder, luong attention), 20 steps each:
     exact launches (steps x (T + L | 2T + L | T + T_a) + one test-sample
     eval x (T + 2L | 2T + 2L | T + 2T_a), T_a = T), a falling loss, one
     step's gradients card vs CPU (and kernel vs plain step for induction,
     whose kernel shapes are new), and an eval of the checkpoint through
     the Evaler (finite; no program metrics for induction); prints each
     family's trainer s/step and eval s/batch;
  7. decode phase: loads the full model's checkpoint from the train phase
     and evaluates 3 batches through the Evaler in each program decode
     mode: beam (K = 5) with --execution_rerank, syntax_greedy and
     syntax_sample; checks 190 launches per batch, that beam search runs
     its program decoder at (B, D) = (bs * K, 512) = (160, 512), that
     every syntax-constrained program parses (syntax accuracy 1.0), that
     beam search with K = 1 decodes the greedy program on the card, that
     the beams agree between the card and the CPU on one batch (tokens and
     lengths exact, scores within 1e-3, on the rows with no beam choice
     within 1e-3 of a tie), and that with the ground truth planted as beam
     2 the rerank picks, in every row, a beam that reproduces every seen
     demo; prints each mode's s/batch and VM share;
  8. scheduled-sampling phase: 10 full-model steps through the Trainer with
     --scheduled_sampling --scheduled_sampling_decay_steps 20: exact
     launches (10 x 125 + 190), a finite loss, and one step's gradients on
     the card vs the CPU on the same injected draws (drawn from the first
     seed whose sampled choices are none within 1e-3 of a tie);
  9. resume phase (Karel): in deterministic mode (train/step.py:
     deterministic_cuda, which the Trainer requires on the card), two
     6-step runs from one seed and a run stopped at step 3 and resumed by
     a new Trainer must save equal checkpoints bit for bit; a fourth run
     with deterministic algorithms off for its steps gives the mode's cost
     in s/step, and eval s/batch is timed in both modes;
 10. ViZDoom phase: generates an in-memory split in 8 shards over a
     process pool (data/vizdoom_memory.py: 80x80x3 DoomLite frames, demos
     of 2-8 frames, programs of at most 32 tokens, 25 seen and 10 unseen
     demos a program; 64 distinct programs train, 32 evaluate), trains
     the full model 20 steps through the Trainer (units 512, bs 32, k 25;
     exact launches 20 x (4T + L) + (5T + 2L), a falling loss, gradients
     card vs CPU and kernel vs plain), evaluates the checkpoint greedily
     (launches at (800, 432), (800, 512) and (32, 512) by forward hooks,
     card vs CPU forward, K = 1 beam = greedy) and by beam K = 5 with
     execution rerank over the 25 stored seen demos while the model reads
     20 (--rerank_k); scores the ground-truth programs in the engine
     (execution 1.0 on seen and unseen demos); repeats the resume phase on
     ViZDoom, with a profile of a train step's device time per kernel in
     each mode; and warm-starts a new bs 8 run from a bs 32 run's
     checkpoint (`--checkpoint`, a new device cache), as a user does;
 11. prints one JSON line describing the kernel: its time, the plain
     version's, torch.lstm_cell's (the one library call that computes the
     same step) and the least time the card could take (bound_ms, by bytes
     or by operations) at every shape, with every path's launches, then
     the result line {"ok": true, "device": {...}} last.

Any failed check raises, so the script exits non-zero and prints no result.
TF32 is off throughout: every comparison is against f32 references.
Deterministic algorithms are on throughout (off only where the resume
phase times the default mode), as the entry points run them.
"""

import contextlib
import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.cli.evaler_cli import parse_args
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.data import vizdoom_memory
from demo2program_tpu_torch.data.vizdoom_generator import (
    VizdoomGeneratorConfig)
from demo2program_tpu_torch.eval.evaler import (
    Evaler, config_from_dataset, fetch_batch, save_checkpoint)
from demo2program_tpu_torch.models import objective
from demo2program_tpu_torch.models.decoder import scheduled_noise
from demo2program_tpu_torch.models.full import FullModel
from demo2program_tpu_torch.models.ops import init_parameters
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops import fused_lstm
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.step import (
    deterministic_cuda, forward_loss, global_norm, sampling_prob, to_device)
from demo2program_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # of every phase's entry points
CARD = ""  # nvidia-smi's "name, power.limit", set by main
OUT_DIR = os.path.join(ROOT, "build", "smoke")
SEED = 1234
UNITS = 512
BATCH = 32
N_BATCHES = 3
SPLIT = SplitConfig(num_programs=BATCH * N_BATCHES, seed=SEED)
# max |kernel - plain| <= ATOL + RTOL * |plain|. f32: both sum 1024
# products in f32 in different orders; bf16: both compute in f32 from the
# same bf16 inputs and round the result to bf16 (2^-8 relative).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
KERNEL_SHAPES = [(B, D) for D in (48, 512) for B in (32, 320)]
# shapes only the induction baseline runs: its demo encoder's input, 48
# CNN features + 5 percepts, at B = bs * k; its attention decoder's cell
# input, [embedding, attention] = 2 * units, at B = bs * test_k
BASELINE_SHAPES = [(320, 53), (160, 1024)]
# beam search folds its K = 5 beams into the batch: the program decoder
# runs at B = bs * K
BEAM_WIDTH = 5
BEAM_SHAPES = [(BATCH * BEAM_WIDTH, 512)]
# ViZDoom's full model at k = 25: the encoder's first pass reads the 5-conv
# features of 80x80 frames (3 * 3 * 48 = 432) at B = bs * k = 800, its
# second pass and the action and perception decoders run at (800, 512)
VZD_K, VZD_TEST_K = 25, 10
VIZDOOM_SHAPES = [(BATCH * VZD_K, 432), (BATCH * VZD_K, 512)]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# HBM bytes/s, and FLOP/s of the tensor cores' TF32 and bf16 products. The
# f32 kernel takes three TF32 products per f32 product (3xTF32 split).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 495e12, torch.bfloat16: 989e12}
PASSES = {torch.float32: 3, torch.bfloat16: 1}
# the model on the card vs the plain path on the CPU, same weights: f32
# sums in other orders through 2*T + L LSTM steps
MODEL_ATOL = 1e-3
TRAIN_STEPS, TRAIN_LOG_STEP = 30, 10
# one train step's gradients, card vs CPU and kernel vs plain step, same
# weights and batch: per parameter, max |diff| <= GRAD_RTOL * max |g| +
# GRAD_ATOL. f32 sums in other orders (cuDNN, cuBLAS, the kernel's 3xTF32
# products) through 4*T + L LSTM steps and back; GRAD_ATOL covers the
# biases that feed BatchNorm (per_embed's, whose gradient is 0 in exact
# arithmetic, and the rn_pool FCs'), whose gradients are sums of terms
# that nearly cancel: small, with the absolute f32 error of the sum.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
LOSS_ATOL, NORM_RTOL = 1e-4, 1e-4
GRAD_ITEMS = 8  # items of the card-vs-CPU step
FAMILIES = ("synthesis_baseline", "summarizer", "induction_baseline")
BASELINE_STEPS, BASELINE_LOG_STEP = 20, 10
TIMING_REPS = 3  # of the turns kernel, plain, plain, kernel
DECODE_MODES = ("beam", "syntax_greedy", "syntax_sample")
# beams card vs CPU: scores within SCORE_ATOL, on the rows where no beam
# choice (the top K + 1 candidates of any step) lies within TIE_GAP of a
# tie, since f32 sums in other orders may break such a tie either way
# (the model's logits differ by about 1e-6 between the two, PERF.md)
SCORE_ATOL, TIE_GAP = 1e-3, 1e-4
SS_STEPS, SS_LOG_STEP, SS_DECAY = 10, 5, 20
# exact resume: runs of RESUME_STEPS steps, one stopped halfway
RESUME_STEPS = 6
PROFILE_STEPS = 3  # profiled ViZDoom train steps in each mode
# the ViZDoom split: VZD_SHARDS generator runs of VZD_PER_SHARD programs
# each (seeds SEED, SEED + 1, ...), of which the first VZD_TRAIN distinct
# programs train and the next VZD_TEST evaluate
VZD_SHARDS, VZD_PER_SHARD = 8, 16
VZD_TRAIN, VZD_TEST = 64, 32
VZD_STEPS, VZD_LOG_STEP, VZD_EVAL_BATCHES = 20, 10, 1
VZD_STAGE_STEPS, VZD_STAGE2_BATCH = 4, 8


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, iters=100, warmup=10):
    """ms per call of back-to-back calls from Python: paced by the host
    whenever a call's launches take longer to enqueue than to run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=50, replays=20):
    """Device ms per call: `calls` back-to-back calls captured in one CUDA
    graph and replayed, timed with CUDA events. The wrappers launch on the
    current stream, which is the capture stream inside the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def host_us(fn, iters=200):
    """Host µs per call: the time Python takes to enqueue one call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def build_phase():
    """Build the kernel library; print ptxas's report and check it."""
    path, seconds, log = fused_lstm.build()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s "
          f"(nvcc sm_90a)", flush=True)
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line:
            print("build: " + line.strip(), flush=True)
    # f32 and bf16 x wide and narrow variant x cp.async and edge loads
    entries = log.count("Compiling entry function")
    check(entries == 8, f"ptxas compiled {entries} kernel instances, "
          f"expected 8")
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    check(spills and all(int(n) == 0 for n in spills),
          "a kernel or a function it calls spills registers")


def bound(B, D, H, dtype):
    """The least time the card could take for one step (ms) and what
    bounds it: each input (x, h, c, W, b) read once and each output (h',
    c') written once at the HBM rate, or the products 2 B (D + H) 4H, in
    PASSES tensor-core passes, at the peak rate of their type."""
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (B * D + 4 * B * H + (D + H) * 4 * H + 4 * H)
    ops = PASSES[dtype] * 2 * B * (D + H) * 4 * H
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = ops / PEAK_FLOPS_S[dtype] * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def kernel_phase():
    """Kernel vs plain version at every shape of the model paths -> list
    of rows; torch.lstm_cell (x @ W[:D] + h @ W[D:] + b, gates i, f, g,
    o as here) timed beside them."""
    dev = torch.device("cuda")
    H = UNITS
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dtype]
        for B, D in (KERNEL_SHAPES + BEAM_SHAPES + BASELINE_SHAPES
                     + VIZDOOM_SHAPES):
            def rnd(*shape, scale=1.0):
                return (torch.randn(*shape, generator=g, device=dev)
                        * scale).to(dtype)
            limit = math.sqrt(6.0 / (D + H + 4 * H))
            x, h, c = rnd(B, D), rnd(B, H), rnd(B, H)
            w, b = rnd(D + H, 4 * H, scale=limit), rnd(4 * H, scale=0.1)
            h_k, c_k = fused_lstm.fused_lstm_step(x, h, c, w, b)
            plan = fused_lstm.last_plan()
            h_r, c_r = fused_lstm.lstm_step_ref(x, h, c, w, b)
            torch.cuda.synchronize()
            err = max((h_k.float() - h_r.float()).abs().max().item(),
                      (c_k.float() - c_r.float()).abs().max().item())
            margin = min((atol + rtol * r.float().abs()
                          - (k.float() - r.float()).abs()).min().item()
                         for k, r in ((h_k, h_r), (c_k, c_r)))

            def kernel():
                fused_lstm.fused_lstm_step(x, h, c, w, b)

            def plain():
                fused_lstm.lstm_step_ref(x, h, c, w, b)

            w_ih, w_hh = w[:D].t().contiguous(), w[D:].t().contiguous()
            b_hh = torch.zeros_like(b)

            def library():
                return torch.lstm_cell(x, (h, c), w_ih, w_hh, b, b_hh)

            h_l, c_l = library()
            lib_err = max((h_l.float() - h_r.float()).abs().max().item(),
                          (c_l.float() - c_r.float()).abs().max().item())
            bound_ms, bound_by = bound(B, D, H, dtype)

            row = {"B": B, "D": D, "H": H, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "atol": atol, "rtol": rtol,
                   "grid": [plan["grid_x"], plan["grid_y"], plan["grid_z"]],
                   "cluster": plan["cluster"], "blocks": plan["blocks"],
                   "vec": plan["vec"],
                   "ms": time_ms(kernel), "plain_ms": time_ms(plain),
                   "device_ms": device_ms(kernel),
                   "plain_device_ms": device_ms(plain),
                   "host_us": host_us(kernel), "plain_host_us": host_us(plain),
                   "library_device_ms": device_ms(library),
                   "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            row["bound_share"] = bound_ms / row["device_ms"]
            print("kernel fused_lstm_step " + json.dumps(row), flush=True)
            check(margin >= 0, f"kernel disagrees with plain version: {row}")
            if dtype == torch.float32:
                check(lib_err <= atol + rtol,
                      f"torch.lstm_cell is not the same step: {row}")
            rows.append(row)
    return rows


def ground_truth_execution(evaler, split, n_batches):
    """Score the ground-truth tokens as predictions with is_same_seq = 0:
    every seen and unseen demo must replay exactly through the VM.
    -> (seen accuracy, unseen accuracy, VM seconds per batch)."""
    cfg, bs = evaler.cfg, evaler.args.batch_size
    seen, test = [], []
    vm0 = evaler.scorer.timings["vm"]
    for s in range(n_batches):
        batch = to_device(split.get_batch_compact(
            split.ids[s * bs:(s + 1) * bs]), evaler.device)
        tokens = batch["program_tokens"]
        lens = batch["program_len"][:, 0].long()
        same = np.zeros(bs, np.float32)
        nc, _ = evaler.scorer.execution_compact(tokens, lens, same, batch)
        tnc, _ = evaler.scorer.execution_compact(tokens, lens, same, batch,
                                                 test=True)
        seen.append(float((nc == cfg.k).mean()))
        test.append(float((tnc == cfg.test_k).mean()))
    vm_s = (evaler.scorer.timings["vm"] - vm0) / n_batches
    return float(np.mean(seen)), float(np.mean(test)), vm_s


def forward_phase(evaler, split, reps=3):
    """Seconds of one eval forward (expand + model + objective) on the
    first batch with every LSTM step in the kernel vs in the plain version,
    same weights, in turns kernel, plain, plain, kernel -> median of each."""
    batch = to_device(split.get_batch_compact(
        split.ids[:evaler.args.batch_size]), evaler.device)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaler.eval_step(batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    times = {"kernel": [], "plain": []}
    for _ in range(reps):
        for name in ("kernel", "plain", "plain", "kernel"):
            if name == "kernel":
                times[name].append(run())
            else:
                with mock.patch.object(fused_lstm, "fused_lstm_step",
                                       fused_lstm.lstm_step_ref):
                    times[name].append(run())
    return {k: float(np.median(v)) for k, v in times.items()}


def _eval_forward(model, cfg, raw, device):
    batch = expand_batch(to_device(raw, device), cfg)
    with torch.no_grad():
        out = model(batch)
        _, report = objective.compute_loss(cfg, out, batch, cfg.model)
    return report, out["pred_program_logits"].cpu()


def reference_agreement(model, cfg, split, n=4):
    """The model on the card (kernel) vs the same weights on the CPU (plain
    version) on the first n items -> max |diff| over the loss report and
    the teacher-forced program logits."""
    cpu_model = FullModel(cfg)
    cpu_model.load_state_dict(model.state_dict())
    raw = fetch_batch(split, split.ids[:n], cfg.dataset_type)
    rep_k, lg_k = _eval_forward(model, cfg, raw,
                                next(model.parameters()).device)
    rep_r, lg_r = _eval_forward(cpu_model.eval(), cfg, raw,
                                torch.device("cpu"))
    diff = max(abs(float(rep_k[k]) - float(rep_r[k])) for k in rep_r)
    return max(diff, (lg_k - lg_r).abs().max().item())


def slice_phase():
    t0 = time.perf_counter()
    split = generate_split(SPLIT)
    print(f"slice: generated {len(split.ids)} programs in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    ckpt = os.path.join(OUT_DIR, f"full_random_{UNITS}.pt")
    args = parse_args([
        "--model", "full", "--dataset_path", "in-memory", "--checkpoint",
        ckpt, "--num_k", str(SPLIT.k), "--batch_size", str(BATCH),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--max_steps", str(N_BATCHES), "--seed", str(SEED),
        "--summary_file", os.path.join(OUT_DIR, "report.txt")])
    cfg = config_from_dataset(args, split)
    model = FullModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    save_checkpoint(model, ckpt)

    evaler = Evaler(args, split)
    cfg = evaler.cfg
    per_batch = lstm_launches(cfg)[1]
    fused_lstm.fused_lstm_step.launches = 0
    loss, acc, hist = evaler.eval_run()
    launches = fused_lstm.fused_lstm_step.launches
    timings = evaler.timings
    summary = {
        "units": UNITS, "k": cfg.k, "test_k": cfg.test_k,
        "T": cfg.max_demo_len, "L": cfg.max_program_len,
        "batch_size": BATCH, "batches": N_BATCHES,
        "loss": loss["loss"],
        "greedy_program_syntax_acc": acc["greedy_program_syntax_acc"],
        "greedy_execution_all_correct":
            float(hist["greedy_program_execution_acc_hist"][-1]),
        **{f"{k}_s": v for k, v in timings.items()},
        "launches": launches, "launches_per_batch_expected": per_batch,
    }
    print("slice " + json.dumps(summary), flush=True)
    check(all(np.isfinite(v).all() for d in (loss, acc, hist)
              for v in d.values()), "non-finite loss or accuracy")
    check(launches == N_BATCHES * per_batch,
          f"{launches} kernel launches, expected {N_BATCHES} x {per_batch}")

    err = reference_agreement(evaler.model, cfg, split)
    print(f"slice: card vs plain CPU path, max |diff| {err:.3g} "
          f"(atol {MODEL_ATOL})", flush=True)
    check(err <= MODEL_ATOL, "model on the card disagrees with the CPU path")

    seen, test, vm_s = ground_truth_execution(evaler, split, N_BATCHES)
    print(f"slice: ground-truth execution seen {seen} test {test} "
          f"(VM {vm_s:.3f} s per batch for 2 run_and_compare calls)",
          flush=True)
    check(seen == 1.0 and test == 1.0,
          "ground-truth programs do not reproduce their demos")
    fwd = forward_phase(evaler, split)
    print("slice: eval forward of one batch, median s " + json.dumps(fwd),
          flush=True)
    return split, launches


def step_grads(model, cfg, batch, **kwargs):
    """One train-mode forward and backward (no update) on a copy of `model`
    -> (loss, grad norm, {parameter: gradient on the CPU}). `kwargs` go to
    the model (scheduled sampling's probability and draws)."""
    model = copy.deepcopy(model)
    loss, _ = forward_loss(model, cfg, batch, cfg.model, **kwargs)
    loss.backward()
    named = list(model.named_parameters())
    norm = global_norm([p.grad for _, p in named])
    return (loss.item(), norm.item(),
            {n: p.grad.detach().cpu() for n, p in named})


def compare_grads(what, a, b):
    """Largest |diff| of loss, grad norm and gradients between two
    step_grads results, checked against the stated tolerances."""
    loss_err = abs(a[0] - b[0])
    norm_err = abs(a[1] - b[1]) / abs(b[1])
    errs = {name: ((a[2][name] - g).abs().max().item(),
                   GRAD_RTOL * g.abs().max().item() + GRAD_ATOL)
            for name, g in b[2].items()}
    worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
    ratio = errs[worst][0] / errs[worst][1]
    out = {"loss_abs_diff": loss_err, "grad_norm_rel_diff": norm_err,
           "max_grad_abs_diff": max(e for e, _ in errs.values()),
           "worst_grad": worst, "worst_grad_abs_diff": errs[worst][0],
           "worst_grad_over_bound": ratio}
    print(f"{what} " + json.dumps(out), flush=True)
    check(loss_err <= LOSS_ATOL, f"{what}: loss differs by {loss_err}")
    check(norm_err <= NORM_RTOL, f"{what}: grad norm differs by {norm_err}")
    check(ratio <= 1.0, f"{what}: gradient of {worst} differs by "
          f"{errs[worst][0]}, over {GRAD_RTOL} * max|g| + {GRAD_ATOL}")
    return out


def step_times(trainer, batch):
    """Seconds of forward, backward and optimizer of one train step, each
    ended by a synchronise."""
    state, cfg = trainer.state, trainer.cfg

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    t0 = now()
    loss, _ = forward_loss(state.model, cfg, batch, cfg.model)
    t1 = now()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    t2 = now()
    state.apply_gradients()
    t3 = now()
    return {"forward": t1 - t0, "backward": t2 - t1, "optimizer": t3 - t2,
            "total": t3 - t0}


def time_train_steps(trainer, batch, steps=3):
    """Median seconds of a step's phases with every LSTM step in the kernel
    vs in the plain version (its autograd), in turns kernel, plain, plain,
    kernel; the first step of each turn is a warm-up."""
    runs = {"kernel": [], "plain": []}
    for _ in range(TIMING_REPS):
        for name in ("kernel", "plain", "plain", "kernel"):
            with (mock.patch.object(fused_lstm, "fused_lstm_step",
                                    fused_lstm.lstm_step_ref)
                  if name == "plain" else contextlib.nullcontext()):
                step_times(trainer, batch)
                runs[name] += [step_times(trainer, batch)
                               for _ in range(steps)]
    return {name: {k: float(np.median([r[k] for r in rs])) for k in rs[0]}
            for name, rs in runs.items()}


def lstm_launches(cfg):
    """Kernel launches of one train step (no greedy decoders) and of one
    eval batch (with them) of cfg.model: one per LSTM step of its encoders
    and decoders. T_a, the width of the test demos' action rows that the
    induction baseline decodes, is T in these splits."""
    T, L = cfg.max_demo_len, cfg.max_program_len
    T_a = T
    return {"full": (4 * T + L, 5 * T + 2 * L),
            "synthesis_baseline": (T + L, T + 2 * L),
            "summarizer": (2 * T + L, 2 * T + 2 * L),
            "induction_baseline": (T + T_a, T + 2 * T_a)}[cfg.model]


def scheduled_kwargs(cpu_model, cfg, batch, step):
    """Scheduled sampling's probability at `step` and draws for `batch` (on
    the CPU), from the first seed at which no sampled id that is fed back
    lies within TIE_GAP of a tie under the CPU model (on the card, f32
    sums in other orders could break such a tie the other way)."""
    p = sampling_prob(cfg, step)
    n, L = batch["program_tokens"].shape
    model = copy.deepcopy(cpu_model).train()
    for seed in range(SEED, SEED + 20):
        noise = scheduled_noise(L, n, cfg.dim_program_token,
                                torch.Generator().manual_seed(seed), "cpu")
        with torch.no_grad():
            out = model(expand_batch(to_device(batch, "cpu"), cfg),
                        include_greedy=False, sampling_prob=p, noise=noise)
        scores = out["pred_program_logits"] + noise[0].transpose(0, 1)
        top2 = scores.topk(2, dim=-1).values
        gaps = (top2[..., 0] - top2[..., 1])[:, :-1]
        fed_back = (noise[1] < p).transpose(0, 1)[:, :-1]
        if not fed_back.any() or gaps[fed_back].min() >= TIE_GAP:
            return {"sampling_prob": p, "noise": noise}
    raise RuntimeError("no draws without a sampled choice near a tie")


def trainer_args(train_dir, steps, log_step, model_name="full",
                 dataset_type="karel", num_k=None, batch_size=None,
                 test_sample_step=None, extra_flags=()):
    """trainer_cli's args of a run on the card at full width (num_k:
    SPLIT's, batch size: BATCH)."""
    num_k = num_k or SPLIT.k
    batch_size = batch_size or BATCH
    return trainer_cli.parse_args([
        "--device", DEVICE, "--model", model_name,
        "--dataset_type", dataset_type, "--dataset_path", "in-memory",
        "--train_dir", train_dir, "--num_k", str(num_k),
        "--batch_size", str(batch_size),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--seed", str(SEED), "--max_steps", str(steps),
        "--log_step", str(log_step),
        "--test_sample_step", str(test_sample_step or steps),
        "--ckpt_save_step", str(steps), *extra_flags])


def train_phase(split, model_name="full", steps=TRAIN_STEPS,
                log_step=TRAIN_LOG_STEP, compare_plain=True,
                time_steps=True, name=None, extra_flags=(),
                check_falling=True, dataset_type="karel", num_k=None,
                test_split=None, eval_batches=N_BATCHES):
    """Train `model_name` through the Trainer (with `extra_flags`) on
    `split`, check launches, loss and one step's gradients, evaluate the
    checkpoint through the Evaler on `test_split` (default `split`)."""
    name = name or model_name
    tag = "train" if name == "full" else name
    num_k = num_k or SPLIT.k
    test_split = test_split or split
    train_dir = os.path.join(OUT_DIR, "train_" + name)
    shutil.rmtree(train_dir, ignore_errors=True)
    args = trainer_args(train_dir, steps, log_step, model_name, dataset_type,
                        num_k, extra_flags=extra_flags)
    trainer = Trainer(args, split, test_split, device=args.device)
    cfg = trainer.cfg
    per_step, per_sample = lstm_launches(cfg)
    losses = []
    train_step = trainer.train_step

    def recorded(batch):  # keeps each step's loss on the card: no sync
        report = train_step(batch)
        losses.append(report["loss"])
        return report

    trainer.train_step = recorded
    fused_lstm.fused_lstm_step.launches = 0
    t0 = time.perf_counter()
    trainer.train(max_steps=steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_lstm.fused_lstm_step.launches
    trainer.train_step = train_step
    samples = len(range(0, steps, args.test_sample_step))
    expected = steps * per_step + samples * per_sample
    check(launches == expected,
          f"{model_name}: {launches} kernel launches in {steps} train steps "
          f"and {samples} test-sample evals, expected {steps} x "
          f"{per_step} + {samples} x {per_sample} = {expected}")
    losses = torch.stack(losses).cpu().numpy()
    windows = losses.reshape(-1, log_step).mean(axis=1)
    check(np.isfinite(losses).all(), f"{name}: non-finite train loss")
    check(windows[-1] < windows[0] or not check_falling,
          f"{name}: mean loss of the last log window {windows[-1]} "
          f"is not below the first one's {windows[0]}")
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    times = {r["step"]: r["time"] for r in rows if r["split"] == "train"}
    ckpt = checkpoint.latest_checkpoint(train_dir)
    check(ckpt == checkpoint.checkpoint_path(train_dir, steps),
          f"{model_name}: newest checkpoint {ckpt}")

    # one step from the trained weights: card vs CPU, kernel vs plain
    batch = fetch_batch(split, split.ids[:GRAD_ITEMS], dataset_type)
    card = to_device(batch, trainer.device)
    cpu_model = get_model_class(model_name)(cfg)
    cpu_model.load_state_dict(trainer.model.state_dict())
    kw_cpu = kw_card = {}
    if cfg.scheduled_sampling:  # the same draws on both sides
        kw_cpu = scheduled_kwargs(cpu_model, cfg, batch, trainer.state.step)
        kw_card = dict(kw_cpu, noise=tuple(
            t.to(trainer.device) for t in kw_cpu["noise"]))
    on_card = step_grads(trainer.model, cfg, card, **kw_card)
    vs_cpu = compare_grads(f"{tag}: card vs CPU", on_card, step_grads(
        cpu_model, cfg, to_device(batch, "cpu"), **kw_cpu))
    vs_plain = None
    if compare_plain:
        with mock.patch.object(fused_lstm, "fused_lstm_step",
                               fused_lstm.lstm_step_ref):
            plain = step_grads(trainer.model, cfg, card, **kw_card)
        vs_plain = compare_grads(f"{tag}: kernel vs plain step", on_card,
                                 plain)

    eval_args = parse_args([
        "--model", model_name, "--dataset_type", dataset_type,
        "--dataset_path", "in-memory", "--checkpoint", ckpt,
        "--num_k", str(num_k), "--batch_size", str(BATCH),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--max_steps", str(eval_batches), "--quiet", "--no_write_summary",
        "--device", DEVICE])
    evaler = Evaler(eval_args, test_split, device=eval_args.device)
    for name, t in trainer.model.state_dict().items():
        check(torch.equal(evaler.model.state_dict()[name], t),
              f"the Evaler's {name} is not the trained one")
    fused_lstm.fused_lstm_step.launches = 0
    loss, acc, hist = evaler.eval_run()
    eval_launches = fused_lstm.fused_lstm_step.launches
    check(eval_launches == eval_batches * per_sample,
          f"{name}: {eval_launches} kernel launches in {eval_batches} "
          f"eval batches, expected {eval_batches} x {per_sample}")
    check(all(np.isfinite(v).all() for d in (loss, acc, hist)
              for v in d.values()), "non-finite eval of the checkpoint")
    has_program = any("program" in k for d in (loss, acc, hist) for k in d)
    check(has_program == (model_name != "induction_baseline"),
          f"{model_name}: program metrics in the eval report: {has_program}")

    summary = {
        "model": model_name, "flags": list(extra_flags), "units": UNITS,
        "batch_size": BATCH, "checkpoint": ckpt,
        "k": cfg.k, "T": cfg.max_demo_len, "L": cfg.max_program_len,
        "steps": steps, "seconds": seconds,
        "trainer_s_per_step": (times[steps] - times[log_step])
        / (steps - log_step),
        "launches": launches, "launches_expected": expected,
        "launches_per_step": per_step, "launches_per_eval": per_sample,
        "test_samples": samples, "loss_windows": windows.tolist(),
        "eval_loss": loss["loss"], "eval_s_per_batch":
        evaler.timings["batch"], "eval_forward_s": evaler.timings["forward"],
        "eval_vm_s": evaler.timings["vm"],
        "card_vs_cpu": vs_cpu, "kernel_vs_plain": vs_plain}
    if time_steps:
        summary["step_s"] = time_train_steps(trainer, trainer.cache.batch(0))
    print(f"{tag} " + json.dumps(summary), flush=True)
    return summary


def baselines_phase(split):
    """The three baseline families, each trained BASELINE_STEPS steps and
    evaluated; kernel vs plain step only for the induction baseline, the
    one family whose kernel shapes no other path runs."""
    return {name: train_phase(split, name, BASELINE_STEPS,
                              BASELINE_LOG_STEP,
                              compare_plain=name == "induction_baseline",
                              time_steps=False)
            for name in FAMILIES}


def decode_evaler(split, ckpt, mode):
    """The Evaler of the trained full model in decode mode `mode` (beam:
    K = BEAM_WIDTH, with --execution_rerank)."""
    flags = ["--model", "full", "--dataset_path", "in-memory",
             "--checkpoint", ckpt, "--num_k", str(SPLIT.k),
             "--batch_size", str(BATCH), "--num_lstm_cell_units", str(UNITS),
             "--cell_impl", "pallas", "--max_steps", str(N_BATCHES),
             "--quiet", "--no_write_summary", "--device", DEVICE,
             "--unroll_type", mode, "--beam_width", str(BEAM_WIDTH)]
    if mode == "beam":
        flags.append("--execution_rerank")
    args = parse_args(flags)
    return Evaler(args, split, device=args.device)


class TopKGaps:
    """Wraps torch.topk while beam search runs: per row, the smallest gap
    among the top K + 1 candidates of any step (the beam's choices and the
    first one it dropped)."""

    def __init__(self):
        self.gaps = None
        self.original = torch.topk

    def __call__(self, x, k, dim=-1, **kw):
        top = self.original(x, k + 1, dim=dim).values
        gap = (top[:, :-1] - top[:, 1:]).min(dim=1).values
        self.gaps = gap if self.gaps is None else torch.minimum(self.gaps,
                                                                gap)
        return self.original(x, k, dim=dim, **kw)


def k1_beam_is_greedy(model, cfg, batch):
    """Beam search with K = 1 decodes the greedy program of the full model
    on `batch` (on the card)."""
    L = cfg.max_program_len
    with torch.no_grad():
        enc = model.encoder(expand_batch(batch, cfg)["s_h"],
                            batch["demo_len"].long())
        c, h = enc["demo_c_summary"], enc["demo_h_summary"]
        b_tok, b_len, _ = model.program_decoder.beam(c, h, L, 1)
        _, g_tok, g_len = model.program_decoder.greedy(c, h, L)
    inside = torch.arange(L, device=c.device)[None, :] < b_len[:, None].long()
    check(torch.equal(b_len, g_len) and torch.equal(
        torch.where(inside, b_tok, -1), torch.where(inside, g_tok, -1)),
          "beam search with K = 1 does not decode the greedy program")


def beam_checks(evaler, split):
    """On the first batch: K = 1 beam search vs greedy on the card; the
    beams on the card vs the CPU; the planted rerank."""
    cfg, model, dev = evaler.cfg, evaler.model, evaler.device
    raw = split.get_batch_compact(split.ids[:BATCH])
    batch = to_device(raw, dev)
    k1_beam_is_greedy(model, cfg, batch)

    with torch.no_grad():
        out_k = model(expand_batch(batch, cfg), decode_mode="beam")
        cpu_model = FullModel(cfg)
        cpu_model.load_state_dict(model.state_dict())
        gaps = TopKGaps()
        with mock.patch.object(torch, "topk", gaps):
            out_c = cpu_model.eval()(expand_batch(to_device(raw, "cpu"), cfg),
                                     decode_mode="beam")
    rows = gaps.gaps >= TIE_GAP
    n_rows = int(rows.sum())
    check(n_rows >= BATCH // 4, f"only {n_rows} of {BATCH} rows have no "
          f"beam choice within {TIE_GAP} of a tie")
    tok_k, tok_c = (o["beam_tokens"].cpu()[rows] for o in (out_k, out_c))
    len_k, len_c = (o["beam_lengths"].cpu()[rows] for o in (out_k, out_c))
    sc_k, sc_c = (o["beam_scores"].cpu()[rows] for o in (out_k, out_c))
    score_err = (sc_k - sc_c).abs().max().item()
    check(torch.equal(tok_k, tok_c) and torch.equal(len_k, len_c),
          "beam tokens or lengths differ between the card and the CPU")
    check(score_err <= SCORE_ATOL,
          f"beam scores differ by {score_err} between the card and the CPU")

    tokens = out_k["beam_tokens"].cpu().numpy().copy()
    lengths = out_k["beam_lengths"].cpu().numpy().copy()
    tokens[:, 2] = raw["program_tokens"]
    lengths[:, 2] = raw["program_len"][:, 0]
    pick = evaler.scorer.rerank_pick(tokens, lengths, batch)
    picked = np.arange(BATCH)
    nc, _ = evaler.scorer.execution_compact(
        tokens[picked, pick], lengths[picked, pick],
        np.zeros(BATCH, np.float32), batch)
    check((nc == cfg.k).all(), "a reranked beam does not reproduce its "
          "seen demos with the ground truth planted as beam 2")
    return {"k1_equals_greedy": True, "cpu_rows_compared": n_rows,
            "cpu_score_max_abs_diff": score_err,
            "planted_picks": np.bincount(pick, minlength=BEAM_WIDTH).tolist()}


def decode_phase(split, ckpt):
    """Evaluate the trained full model's checkpoint in each decode mode."""
    results = {}
    for mode in DECODE_MODES:
        evaler = decode_evaler(split, ckpt, mode)
        per_batch = lstm_launches(evaler.cfg)[1]
        shapes = {}  # (B, D) of the cells' launches -> the first's plan

        def record(cell, inputs, output):
            shapes.setdefault(tuple(inputs[1].shape), fused_lstm.last_plan())

        hooks = [m.register_forward_hook(record)
                 for m in evaler.model.modules()
                 if isinstance(m, fused_lstm.FusedLSTMCell)]
        fused_lstm.fused_lstm_step.launches = 0
        loss, acc, hist = evaler.eval_run()
        launches = fused_lstm.fused_lstm_step.launches
        for hook in hooks:
            hook.remove()
        check(launches == N_BATCHES * per_batch,
              f"{mode}: {launches} kernel launches in {N_BATCHES} batches, "
              f"expected {N_BATCHES} x {per_batch}")
        check(all(np.isfinite(v).all() for d in (loss, acc, hist)
                  for v in d.values()), f"{mode}: non-finite report")
        t = evaler.timings
        res = {"mode": mode, "launches": launches,
               "s_per_batch": t["batch"], "forward_s": t["forward"],
               "vm_s": t["vm"], "vm_share": sum(t["vm"]) / sum(t["batch"]),
               "greedy_program_syntax_acc": acc["greedy_program_syntax_acc"],
               "greedy_exact_program_accuracy":
                   acc["greedy_exact_program_accuracy"],
               "greedy_execution_all_correct":
                   float(hist["greedy_program_execution_acc_hist"][-1]),
               "shapes": sorted(shapes)}
        if mode == "beam":
            beam_shape = (BATCH * BEAM_WIDTH, UNITS)
            check(beam_shape in shapes, f"beam: no launch at {beam_shape}: "
                  f"{sorted(shapes)}")
            res["beam_plan"] = shapes[beam_shape]
            res["rerank_changed_rate"] = acc["rerank_changed_rate"]
            res.update(beam_checks(evaler, split))
        else:
            check(acc["greedy_program_syntax_acc"] == 1.0,
                  f"{mode}: a constrained program does not parse")
        print("decode " + json.dumps(res), flush=True)
        results[mode] = res
    return results


def equal_states(a, b):
    """Are two train states (checkpoint dicts) equal bit for bit: step,
    every parameter and buffer, and Adam's moments and counts?"""
    if a["step"] != b["step"] or set(a["model"]) != set(b["model"]):
        return False
    if any(not torch.equal(a["model"][k], b["model"][k])
           for k in a["model"]):
        return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return set(sa) == set(sb) and all(
        torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
        for i in sa for k in sa[i])


def rate(train_dir, steps, log_step):
    """The trainer's s/step over the steps after the first log line."""
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    times = {r["step"]: r["time"] for r in rows if r["split"] == "train"}
    return (times[steps] - times[log_step]) / (steps - log_step)


def eval_modes(ckpt, split, dataset_type, num_k):
    """Eval s/batch of `ckpt` (up to N_BATCHES batches of `split`) with
    deterministic algorithms on and off, in turns on, off, off, on ->
    {"deterministic": [...], "default": [...]} (every batch of every turn
    after the first turn's first batch)."""
    batches = min(N_BATCHES, len(split.ids) // BATCH)
    args = parse_args([
        "--model", "full", "--dataset_type", dataset_type,
        "--dataset_path", "in-memory", "--checkpoint", ckpt,
        "--num_k", str(num_k), "--batch_size", str(BATCH),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--max_steps", str(batches), "--quiet", "--no_write_summary",
        "--device", DEVICE])
    evaler = Evaler(args, split, device=args.device)
    times = {"deterministic": [], "default": []}
    for turn, mode in enumerate(("deterministic", "default", "default",
                                 "deterministic")):
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            evaler.eval_run()
        finally:
            torch.use_deterministic_algorithms(True)
        times[mode] += evaler.timings["batch"][1 if turn == 0 else 0:]
    return times


def mode_profile(trainer, steps=PROFILE_STEPS, top=8):
    """Where a train step's device time goes with deterministic algorithms
    on and off: `steps` profiled steps in each mode (after one unprofiled
    step) on the stream's first batch -> {"on_us": device µs a step,
    "off_us": ..., "ops": [[kernel, on µs, off µs], ...] for the `top`
    kernels whose time a step moves most between the modes}."""
    batch = trainer.cache.batch(0)
    per_step = {}
    for mode in (True, False):
        torch.use_deterministic_algorithms(mode)
        try:
            trainer.train_step(batch)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    trainer.train_step(batch)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(True)
        # the kernels' rows only: an operator's row repeats the device
        # time of the kernels it launched
        per_step[mode] = {
            e.key: e.self_device_time_total / steps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    on, off = per_step[True], per_step[False]
    names = sorted(set(on) | set(off),
                   key=lambda n: -abs(on.get(n, 0) - off.get(n, 0)))
    return {"on_us": sum(on.values()), "off_us": sum(off.values()),
            "ops": [[n[:120], on.get(n, 0), off.get(n, 0)]
                    for n in names[:top]]}


def resume_phase(tag, split, test_split, dataset_type="karel",
                 num_k=None, steps=RESUME_STEPS, profile=False):
    """Exact resume on the card (deterministic mode, which main turns on
    as the entry points do): two runs of `steps` steps from one seed, and a
    run stopped at steps // 2 and resumed by a new Trainer, must all save
    the same checkpoint bit for bit. Then the same run with deterministic
    algorithms off for its steps, for the mode's cost in s/step, and with
    `profile` the device time of a step in each mode (mode_profile)."""
    log_step = steps // 2

    def run(name, max_steps, target=None, deterministic=True):
        train_dir = os.path.join(OUT_DIR, f"resume_{tag}_{name}")
        if target is None:
            shutil.rmtree(train_dir, ignore_errors=True)
        args = trainer_args(train_dir, steps, log_step,
                            dataset_type=dataset_type, num_k=num_k,
                            test_sample_step=steps)
        trainer = Trainer(args, split, test_split, device=args.device)
        if target is not None:  # the killed run's stage target
            with open(os.path.join(train_dir, "resume.json"), "w") as f:
                json.dump({"target_step": target}, f)
        torch.use_deterministic_algorithms(deterministic)
        try:
            trainer.train(max_steps=max_steps)
        finally:
            torch.use_deterministic_algorithms(True)
        torch.cuda.synchronize()
        return train_dir, trainer

    def saved(train_dir):
        return checkpoint.load(checkpoint.checkpoint_path(train_dir, steps))

    dir_a, trainer_a = run("a", steps)
    dir_b, _ = run("b", steps)
    dir_c, _ = run("c", log_step)
    _, resumed = run("c", steps, target=steps)
    check(resumed._auto_resumed, f"{tag}: the relaunch did not resume")
    first = saved(dir_a)
    same_runs = equal_states(first, saved(dir_b))
    same_resumed = equal_states(first, saved(dir_c))
    dir_d, _ = run("d", steps, deterministic=False)
    evals = eval_modes(checkpoint.checkpoint_path(dir_a, steps), test_split,
                       dataset_type, num_k or SPLIT.k)
    res = {"card": CARD, "steps": steps,
           "two_runs_bitwise_equal": same_runs,
           "resumed_run_bitwise_equal": same_resumed,
           "deterministic_s_per_step": rate(dir_a, steps, log_step),
           "deterministic_s_per_step_b": rate(dir_b, steps, log_step),
           "default_s_per_step": rate(dir_d, steps, log_step),
           "default_run_bitwise_equal": equal_states(first, saved(dir_d)),
           "eval_s_per_batch": evals}
    if profile:  # after the checkpoints: the profiled steps move trainer_a
        res["step_device_profile"] = mode_profile(trainer_a)
    print(f"resume_{tag} " + json.dumps(res), flush=True)
    check(same_runs, f"{tag}: two runs from one seed differ on the card")
    check(same_resumed, f"{tag}: the resumed run differs from the "
          f"uninterrupted one")
    return res


def vizdoom_split():
    """An in-memory ViZDoom split at the generator's published shapes
    (80x80x3 frames, demos of 2-8 frames, programs of at most 32 tokens,
    simple percepts, sprite style v2) with k = 25 seen and 10 unseen demos,
    made in shards over a process pool -> (train split of VZD_TRAIN
    distinct programs, test split of the next VZD_TEST, seconds)."""
    cfg = VizdoomGeneratorConfig(num_demo_per_program=VZD_K,
                                 num_test_demo_per_program=VZD_TEST_K)
    workers = min(VZD_SHARDS, os.cpu_count() or 1)
    t0 = time.perf_counter()
    split = vizdoom_memory.generate_split(
        cfg, num_programs=VZD_PER_SHARD,
        shard_seeds=[SEED + i for i in range(VZD_SHARDS)], processes=workers)
    seconds = time.perf_counter() - t0
    distinct, seen = [], set()
    for id_ in split.ids:
        program = bytes(split._store[id_]["program"])
        if program not in seen:
            seen.add(program)
            distinct.append(id_)
    print(f"vizdoom: generated {len(split.ids)} programs ({len(distinct)} "
          f"distinct) in {seconds:.1f} s with {workers} processes; T "
          f"{split.max_demo_len}, L {split.max_program_len}", flush=True)
    check(len(distinct) >= VZD_TRAIN + VZD_TEST,
          f"{len(distinct)} distinct ViZDoom programs generated, need "
          f"{VZD_TRAIN + VZD_TEST}")
    return (split.subset(distinct[:VZD_TRAIN], "train"),
            split.subset(distinct[VZD_TRAIN:VZD_TRAIN + VZD_TEST], "test"),
            seconds)


def vizdoom_evaler(ckpt, test_split, mode="greedy", num_k=VZD_K):
    flags = ["--model", "full", "--dataset_type", "vizdoom",
             "--dataset_path", "in-memory", "--checkpoint", ckpt,
             "--num_k", str(num_k), "--batch_size", str(BATCH),
             "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
             "--max_steps", str(VZD_EVAL_BATCHES), "--quiet",
             "--no_write_summary", "--device", DEVICE, "--unroll_type", mode]
    if mode == "beam":
        flags += ["--beam_width", str(BEAM_WIDTH), "--execution_rerank",
                  "--rerank_k", str(VZD_K)]
    args = parse_args(flags)
    return Evaler(args, test_split.subset(test_split.ids, "test", num_k),
                  device=args.device)


def vizdoom_phase():
    """The ViZDoom full model on the card at units 512, bs 32, k 25: train
    through the Trainer, evaluate greedy and beam + rerank through the
    Evaler, hold the engine oracle, exact resume and the bs 32 -> 8 warm
    start."""
    train_split, test_split, gen_s = vizdoom_split()
    train = train_phase(train_split, steps=VZD_STEPS, log_step=VZD_LOG_STEP,
                        time_steps=False, name="vizdoom",
                        dataset_type="vizdoom", num_k=VZD_K,
                        test_split=test_split, eval_batches=VZD_EVAL_BATCHES)
    ckpt = train["checkpoint"]

    # the greedy eval again, its LSTM shapes seen by forward hooks, and the
    # card against the CPU
    evaler = vizdoom_evaler(ckpt, test_split)
    cfg = evaler.cfg
    shapes = {}

    def record(cell, inputs, output):
        shapes.setdefault(tuple(inputs[1].shape), fused_lstm.last_plan())

    hooks = [m.register_forward_hook(record) for m in evaler.model.modules()
             if isinstance(m, fused_lstm.FusedLSTMCell)]
    loss, acc, hist = evaler.eval_run()
    for hook in hooks:
        hook.remove()
    want = {(BATCH * VZD_K, 432), (BATCH * VZD_K, UNITS), (BATCH, UNITS)}
    check(want <= set(shapes), f"vizdoom: LSTM launches at {sorted(shapes)},"
          f" expected {sorted(want)}")
    err = reference_agreement(evaler.model, cfg, test_split)
    check(err <= MODEL_ATOL, f"vizdoom: card vs CPU forward differs by {err}")
    batch = to_device(fetch_batch(test_split, test_split.ids[:BATCH],
                                  "vizdoom"), evaler.device)
    k1_beam_is_greedy(evaler.model, cfg, batch)

    # the engine oracle: ground-truth programs reproduce their seen and
    # unseen demos in DoomLite, frames shrunk by area_resize
    t0 = time.perf_counter()
    raw = fetch_batch(test_split, test_split.ids[:BATCH], "vizdoom")
    scorer = evaler.scorer
    tokens, lens = raw["program_tokens"], raw["program_len"][:, 0]
    same = np.zeros(BATCH, np.float32)
    nc, _ = scorer.execution(tokens, lens, same, raw["s_h"], raw["demo_len"],
                             raw["init_pos"], raw["init_pos_len"])
    tnc, _ = scorer.execution(tokens, lens, same, raw["test_s_h"],
                              raw["test_demo_len"], raw["test_init_pos"],
                              raw["test_init_pos_len"])
    oracle = {"seen": float((nc == cfg.k).mean()),
              "unseen": float((tnc == cfg.test_k).mean()),
              "seconds": time.perf_counter() - t0}
    check(oracle["seen"] == 1.0 and oracle["unseen"] == 1.0,
          f"vizdoom: ground-truth programs do not reproduce their demos "
          f"{oracle}")

    # beam K = 5 with execution rerank over all 25 stored seen demos, the
    # model reading 20 of them (so --rerank_k re-reads the other 5)
    beam = vizdoom_evaler(ckpt, test_split, "beam", num_k=VZD_K - 5)
    per_batch = lstm_launches(beam.cfg)[1]
    fused_lstm.fused_lstm_step.launches = 0
    b_loss, b_acc, b_hist = beam.eval_run()
    b_launches = fused_lstm.fused_lstm_step.launches
    check(b_launches == VZD_EVAL_BATCHES * per_batch,
          f"vizdoom beam: {b_launches} launches, expected "
          f"{VZD_EVAL_BATCHES} x {per_batch}")
    check(all(np.isfinite(v).all() for d in (b_loss, b_acc, b_hist)
              for v in d.values()), "vizdoom beam: non-finite report")

    resume = resume_phase("vizdoom", train_split, test_split, "vizdoom",
                          VZD_K, profile=True)

    # the two-stage recipe as a user runs it: bs 32, then a new run that
    # warm-starts from its checkpoint at bs 8 (`--checkpoint`)
    stage1_dir = os.path.join(OUT_DIR, "vizdoom_stage1")
    shutil.rmtree(stage1_dir, ignore_errors=True)
    stage1 = Trainer(trainer_args(stage1_dir,
                                  VZD_STAGE_STEPS, VZD_STAGE_STEPS,
                                  dataset_type="vizdoom", num_k=VZD_K),
                     train_split, test_split, device=DEVICE)
    stage1.train(max_steps=VZD_STAGE_STEPS)
    stage1_ckpt = checkpoint.latest_checkpoint(stage1.train_dir)
    stage2_dir = os.path.join(OUT_DIR, "vizdoom_stage2")
    shutil.rmtree(stage2_dir, ignore_errors=True)
    stage2 = Trainer(trainer_args(stage2_dir, VZD_STAGE_STEPS,
                                  VZD_STAGE_STEPS, dataset_type="vizdoom",
                                  num_k=VZD_K, batch_size=VZD_STAGE2_BATCH,
                                  extra_flags=("--checkpoint", stage1_ckpt)),
                     train_split, test_split, device=DEVICE)
    check(stage2.state.step == VZD_STAGE_STEPS
          and stage2.cache.batch_size == VZD_STAGE2_BATCH,
          "vizdoom: the bs 8 stage did not start from the bs 32 stage")
    stage2.train(max_steps=VZD_STAGE_STEPS)
    with open(os.path.join(stage2_dir, "metrics.jsonl")) as f:
        stage2_loss = [json.loads(line)["loss"] for line in f
                       if '"train"' in line]
    check(stage2.state.step == 2 * VZD_STAGE_STEPS
          and np.isfinite(stage2_loss).all(),
          f"vizdoom: the bs 8 stage ended at step {stage2.state.step}, "
          f"losses {stage2_loss}")

    res = {"card": CARD, "generation_s": gen_s,
           "programs_train": len(train_split.ids),
           "programs_test": len(test_split.ids), "k": cfg.k,
           "test_k": cfg.test_k, "T": cfg.max_demo_len,
           "L": cfg.max_program_len, "train": train,
           "greedy_shapes": sorted(shapes),
           "greedy_plans": {f"{b}x{d}": p for (b, d), p in shapes.items()},
           "card_vs_cpu_forward": err, "k1_beam_equals_greedy": True,
           "greedy_s_per_batch": evaler.timings["batch"],
           "greedy_vm_share": sum(evaler.timings["vm"])
           / sum(evaler.timings["batch"]),
           "engine_oracle": oracle, "beam_launches": b_launches,
           "beam_s_per_batch": beam.timings["batch"],
           "beam_vm_share": sum(beam.timings["vm"])
           / sum(beam.timings["batch"]),
           "beam_rerank_changed_rate": b_acc.get("rerank_changed_rate"),
           "resume": resume, "stage2_losses": stage2_loss}
    print("vizdoom " + json.dumps(res), flush=True)
    return res


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # as the entry points do, before any CUDA work (cuBLAS reads its
    # workspace config when its first handle is made)
    deterministic_cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    global CARD
    CARD = smi.stdout.strip()
    print(CARD, flush=True)

    build_phase()
    rows = kernel_phase()
    split, launches = slice_phase()
    train = train_phase(split)
    baselines = baselines_phase(split)
    decode = decode_phase(split, train["checkpoint"])
    ss = train_phase(split, steps=SS_STEPS, log_step=SS_LOG_STEP,
                     compare_plain=False, time_steps=False,
                     name="full_scheduled", check_falling=False,
                     extra_flags=("--scheduled_sampling",
                                  "--scheduled_sampling_decay_steps",
                                  str(SS_DECAY)))
    resume = resume_phase("karel", split, split)
    vizdoom = vizdoom_phase()

    def timed(r):  # the contract's names, device times of this run
        return {"ms": r["device_ms"], "plain_ms": r["plain_device_ms"],
                "library_ms": r["library_device_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"]}

    f32 = [r for r in rows if r["dtype"] == "float32"]
    main_shape = next(r for r in f32 if r["B"] == 320 and r["D"] == 512)
    print(json.dumps({"kernels": [{
        "name": "fused_lstm_step", "route": "cuda",
        "source": "demo2program_tpu_torch/csrc/fused_lstm.cu",
        "replaces": "demo2program_tpu/ops/pallas_lstm.py:70",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        **timed(main_shape), "shape": [320, 512, UNITS],
        "path_launches": {
            "eval": launches, "train": train["launches"],
            **{name: b["launches"] for name, b in baselines.items()},
            **{f"decode_{m}": d["launches"] for m, d in decode.items()},
            "train_scheduled_sampling": ss["launches"],
            "vizdoom_train": vizdoom["train"]["launches"],
            "vizdoom_beam": vizdoom["beam_launches"]},
        "shapes": [dict(r, **timed(r)) for r in rows]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
