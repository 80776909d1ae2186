#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and the repository checkout; exits non-zero
without them. It:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the fused LSTM kernel from demo2program_tpu_torch/csrc with nvcc
     for sm_90a, prints the build time and ptxas's registers, shared memory
     and spills for every kernel instance, and checks that none spills;
  3. kernel phase: holds the kernel against its plain PyTorch version on the
     card at every shape of the full model's path (D in {48, 512},
     H = 512, B in {32, 320}), at the recipe evals' (200, 48) and (20, 512)
     (the evaler's batch of 20), at beam search's (160, 512), at the two
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
     evaluates 2 batches of 32 through the port's Evaler with
     --checkpoint, checks that every LSTM step of the run went through the
     kernel (5*T + 2*L launches per batch), that the report is finite, that
     the model on the card agrees with the plain CPU path on a small batch,
     and that the ground-truth programs score execution 1.0 on the seen
     and the unseen demos (replay + VM on the card); then times one eval
     forward with the kernel against one with the plain LSTM step;
  5. train phase: builds the port's Trainer through trainer_cli's parser
     (--device cuda, units 512, bs 32, k=10, cell_impl pallas) on the same
     split and trains 20 steps (log every 10, one test-sample eval,
     checkpoint at 20); checks that every forward LSTM step went through
     the kernel (20 x (4*T + L) + 190 per test-sample eval), that the loss
     is finite and its mean over the last log window is below the first
     window's; compares one step's loss, grad norm and every gradient on
     the card (kernel forward, recomputing backward) with the CPU (plain)
     and with the card's plain step under autograd; evaluates the final
     checkpoint through the Evaler (2 batches, 190 launches each); times
     forward, backward and optimizer of a step with the kernel against the
     plain step, in turns;
  6. baselines phase: the same for synthesis_baseline, summarizer and
     induction_baseline (lstm encoder, luong attention), 10 steps each:
     exact launches (steps x (T + L | 2T + L | T + T_a) + one test-sample
     eval x (T + 2L | 2T + 2L | T + 2T_a), T_a = T), a falling loss, one
     step's gradients card vs CPU (and kernel vs plain step for induction,
     whose kernel shapes are new), and an eval of the checkpoint through
     the Evaler (finite; no program metrics for induction); prints each
     family's trainer s/step and eval s/batch;
  7. decode phase: loads the full model's checkpoint from the train phase
     and evaluates it through the Evaler in each program decode mode:
     beam (K = 5) with --execution_rerank over 2 batches, syntax_greedy
     and syntax_sample over one; checks 190 launches per batch, that beam
     search runs its program decoder at (B, D) = (bs * K, 512) = (160,
     512), that every syntax-constrained program parses (syntax accuracy 1.0), that
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
     4-step runs from one seed and a run stopped at step 2 and resumed by
     a new Trainer must save equal checkpoints bit for bit; a fourth run
     with deterministic algorithms off for its steps gives the mode's cost
     in s/step, and eval s/batch is timed in both modes;
 10. ViZDoom phase: on an in-memory split made in 8 shards by a pool of 4
     processes while the phases above run (data/vizdoom_memory.py:
     80x80x3 DoomLite frames, demos of 2-8 frames, programs of at most 32
     tokens, 25 seen and 10 unseen demos a program; 64 distinct programs train, 32 evaluate), trains
     the full model 10 steps through the Trainer (units 512, bs 32, k 25;
     exact launches 10 x (4T + L) + (5T + 2L), a falling loss, gradients
     card vs CPU and kernel vs plain), evaluates the checkpoint greedily
     (launches at (800, 432), (800, 512) and (32, 512) by forward hooks,
     card vs CPU forward, K = 1 beam = greedy) and by beam K = 5 with
     execution rerank over the 25 stored seen demos while the model reads
     20 (--rerank_k); scores the ground-truth programs in the engine
     (execution 1.0 on seen and unseen demos); repeats the resume phase on
     ViZDoom, with a profile of a train step's device time per kernel in
     each mode; and warm-starts a new bs 8 run from a bs 32 run's
     checkpoint (`--checkpoint`, a new device cache), as a user does;
 11. bf16 phase (`--compute_dtype bfloat16` through the same entry points):
     trains the Karel full model 20 steps with checkpoints at 10 and 20
     (exact launches, every one on the kernel's bf16 entry; a falling loss;
     parameters, buffers, Adam's moments and the checkpoint all f32; one
     step's loss, grad norm and gradients card vs CPU and kernel vs plain
     within BF16_TOL, and bf16 against f32 on the card as a reading);
     times bf16 beside f32 on that trainer in turns (step phases, the eval
     forward, a profile of a step's device time and kernel count); sweeps
     both checkpoints with evaler_cli's --sweep_steps in bf16, greedy and
     then beam K = 5 with --execution_rerank (one Evaler and one summary
     file a step; 190 bf16 launches a batch; every greedy and beam choice
     card vs CPU wherever the CPU's is clear of a tie, the card decoding
     along the CPU's prefix (ChoiceTape); decoded freely, every row's best
     beam score; the planted rerank; ground truth at execution 1.0); holds
     tools/eval_execution.py's batch_check on the card against the
     scorer's verdicts for a batch of ground-truth and of greedy programs;
     trains ViZDoom's full model 10 steps and the induction baseline 20,
     both in bf16 (60 / 99 and 40 / 60 launches, gradients card vs CPU),
     and takes one bf16 step of the induction variant that the JAX
     package runs in bf16 (state features concatenated to the memory);
     every phase prints its seconds (`phase <name>: ... s`);
 12. data phase: builds the native Karel engine with g++ and generates the
     split's 64 programs (k 10, test_k 5) in memory with both backends of
     data/karel_generator.py (the card's machine has no h5py): the records
     must be equal, array for array, and their compact form must be the
     in-memory split; prints each backend's programs/s with the host's CPU.
     Then trains streamed (D2P_KAREL_DEVICE_CACHE=0 /
     D2P_DOOM_DEVICE_CACHE=0: data/pipeline.py ships each batch on its own
     stream ahead of the step): Karel 20 steps (20 x 125 + 190 launches, a
     falling loss, gradients card vs CPU, the checkpoint evaluated) and
     ViZDoom 10 steps at k 25 (10 x 60 + 99), printing the bytes shipped a
     step and each log line's sec_data_wait; times the streamed loop beside
     the device cache in turns (cache, stream, stream, cache) on both
     domains; checks bitwise exact resume streamed (two runs and a resumed
     run, both domains); and runs 2 streamed steps with --profile_steps 1
     --profile_start 1 --sample_images: the Chrome trace of step 1 must
     parse and name the LSTM kernel exactly 125 times, and the four sample
     PNGs of step 0 must decode (utils/png.py) to their expected sizes;
 13. dp phase (data parallelism, parallel/mesh.py, through the Trainer;
     each rank a process spawned with torch.multiprocessing and a file
     store): NCCL at world 1, 20 Karel steps whose checkpoint must equal the
     train phase's single-process checkpoint bit for bit; then gloo at world
     2 with both ranks on cuda:0 (NCCL takes one card a rank): 10 Karel
     steps from the replicated device cache and 10 ViZDoom steps from the
     sharded one, every step's loss (1e-4) and grad norm (rtol 1e-4) held
     against the single process's step from the same parameters on the same
     global batch, the two ranks' parameters bitwise equal after every step,
     exact launches per rank (10 x 125 + 190, 10 x 60 + 99), a run stopped
     at step 5 and resumed bitwise equal to the uninterrupted one; prints
     the distance of an independent single-process run over the same
     batches and a line with the world-2 step's time split into compute,
     the gradients' all-reduce and the optimizer, with the card's name and
     power limit. The kernel phase also holds the kernel at a rank's shapes
     ((160, 48), (16, 512), (400, 432), (400, 512)). On a machine with
     several cards the same runs over NCCL, a card a rank, beside the
     single-process step timed in the same call, and with four cards or
     more Karel on the 2-D mesh below, a card a rank; then the dp bf16
     phase: the same gloo world 2 with --compute_dtype bfloat16, 4 Karel
     and 4 ViZDoom steps, each within BF16_TOL of the single process's
     bf16 step from the same parameters, the replicas bitwise equal, 4 x
     125 + 190 / 4 x 60 + 99 launches a rank, all on the bf16 entry;
 14. dp demo phase (the 2-D data x demo mesh, parallel/mesh.py:
     make_mesh_2d and shard_batch_2d, through the port's train step; gloo,
     every rank a spawned process on cuda:0): the Karel full model at dp 2
     x demo 2 (world 4, 5 of the 10 demos and 16 rows a rank), 10 steps on
     expanded batches and 10 on the compact wire, and ViZDoom's at dp 1 x
     demo 5 (world 5, 5 of the 25 demos a rank), 10 steps; every step's
     loss (1e-4) and grad norm (rtol 1e-4) held against the single
     process's step from the same parameters on the same global batch, the
     ranks' parameters bitwise equal after every step, exactly 125 / 60
     launches a rank a step; prints the step's time split into compute, the
     demo group's, the data group's and the world's collectives and the
     gradients' all-reduce, beside the single process's step, with the
     card's name and power limit. The kernel phase also holds the kernel
     at a rank's shapes ((80, 48), (80, 512), (160, 432)). Each spawn also
     takes 4 bf16 steps under the same gates at BF16_TOL, all launches on
     the bf16 entry. The Karel spawn also evaluates the train phase's
     checkpoint on one global batch in greedy, beam (K = 5, then the
     execution rerank), syntax_greedy and syntax_sample through the 2-D
     eval step against the single process's eval step (190 launches a rank
     a mode; report within 1e-4; token ids, lengths and rerank picks equal
     on every row whose choices in the single process lie TIE_GAP clear of
     a tie, at least a quarter of the batch), and takes one step from each
     2-D batch source (KarelDeviceCache, BatchPipeline, DoomDeviceCache at
     k 20) that must equal the step on shard_batch_2d of the same global
     batch bit for bit;
 15. recipe phase (cli/recipe_cli.py, stage S of the JAX package's Karel
     recipe): generates a 96 / 40 / 40 three-way split in memory with the
     native engine (data/karel_memory.py:generate_splits), runs the recipe
     at full width (synthesis, units 512, bs 32, k 10) for 40 steps with a
     checkpoint every 10, val at 20, 30 and 40 (2 batches of 20 each) and
     the test eval of the selected step, in one process; then the same run
     stopped at 20 through its carry and resumed in a fresh directory: the
     final train states must be equal bit for bit, the best step and every
     report the same, and every stage's launches T + L a step and T + 2L
     an eval batch of the split's T and L (61 and 102 on karel_25k, whose
     data_info has T 20, L 41);
 16. prints one JSON line describing the kernel: its time, the plain
     version's, torch.lstm_cell's (the one library call that computes the
     same step) and the least time the card could take (bound_ms, by bytes
     or by operations) at every shape, with every path's launches, then
     the result line {"ok": true, "device": {...}} last.

Any failed check raises, so the script exits non-zero and prints no result.
TF32 is off throughout, and bf16 GEMMs reduce in f32
(train/step.py:full_precision_matmuls).
Deterministic algorithms are on throughout (off only where the resume
phase times the default mode), as the entry points run them.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import platform
import re
import shutil
import subprocess
import sys
import time
import types
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from demo2program_tpu_torch import native
from demo2program_tpu_torch.cli import evaler_cli, recipe_cli, trainer_cli
from demo2program_tpu_torch.cli.evaler_cli import parse_args
from demo2program_tpu_torch.data.karel_generator import (
    GeneratorConfig, generate_records)
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split, generate_splits, split_from_records)
from demo2program_tpu_torch.data.pipeline import BatchPipeline
from demo2program_tpu_torch.data import vizdoom_memory
from demo2program_tpu_torch.data.vizdoom_generator import (
    VizdoomGeneratorConfig)
from demo2program_tpu_torch.eval import evaler as evaler_module
from demo2program_tpu_torch.eval.evaler import (
    Evaler, config_from_dataset, fetch_batch, save_checkpoint)
from demo2program_tpu_torch.eval.scorer import KarelScorer
from demo2program_tpu_torch.models import objective
from demo2program_tpu_torch.models.common import COMPUTE_DTYPES
from demo2program_tpu_torch.models.decoder import scheduled_noise
from demo2program_tpu_torch.models.full import FullModel
from demo2program_tpu_torch.models.ops import init_parameters
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.ops import fused_lstm
from demo2program_tpu_torch.ops.reconstruct import expand_batch
from demo2program_tpu_torch.parallel.mesh import (
    all_reduce_gradients, data_axis, gather_rows, make_mesh, make_mesh_2d,
    shard_batch_2d)
from demo2program_tpu_torch.tools import eval_execution
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train import step as step_module
from demo2program_tpu_torch.train.device_cache import (
    DoomDeviceCache, KarelDeviceCache)
from demo2program_tpu_torch.train.step import (
    TrainState, compute_call, deterministic_cuda, forward_loss,
    full_precision_matmuls, global_norm, make_eval_step, make_train_step,
    sampling_prob, to_device)
from demo2program_tpu_torch.train.trainer import Trainer
from demo2program_tpu_torch.utils.png import read_png

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"  # of every phase's entry points
CARD = ""  # nvidia-smi's "name, power.limit", set by main
OUT_DIR = os.path.join(ROOT, "build", "smoke")
SEED = 1234
UNITS = 512
BATCH = 32
N_BATCHES = 2
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
# the recipe's evals (cli/recipe_cli.py) run at the evaler's batch of 20:
# the encoder at B = 20 * k, the program decoder at 20
RECIPE_EVAL_SHAPES = [(20 * 10, 48), (20, 512)]
# beam search folds its K = 5 beams into the batch: the program decoder
# runs at B = bs * K
BEAM_WIDTH = 5
BEAM_SHAPES = [(BATCH * BEAM_WIDTH, 512)]
# ViZDoom's full model at k = 25: the encoder's first pass reads the 5-conv
# features of 80x80 frames (3 * 3 * 48 = 432) at B = bs * k = 800, its
# second pass and the action and perception decoders run at (800, 512)
VZD_K, VZD_TEST_K = 25, 10
VIZDOOM_SHAPES = [(BATCH * VZD_K, 432), (BATCH * VZD_K, 512)]
# a rank's rows of a data-parallel step at world DP_WORLD: Karel (bs / 2) *
# k = 160 rows at D 48 (and 512, beam's shape), the program decoder at 16;
# ViZDoom 400 rows at D 432 and 512
DP_WORLD = 2
DP_SHAPES = [(BATCH // DP_WORLD * SPLIT.k, 48), (BATCH // DP_WORLD, 512),
             (BATCH // DP_WORLD * VZD_K, 432), (BATCH // DP_WORLD * VZD_K,
                                                 512)]
# the 2-D data x demo mesh (parallel/mesh.py:make_mesh_2d), (dp, demo_par)
# per domain: Karel's k 10 at dp 2 x demo 2, ViZDoom's k 25 at dp 1 x demo
# 5. A Karel rank runs its 16 rows x 5 demos = 80 rows through the encoder
# and the action and perception decoders, the program decoder at (16,
# 512); a ViZDoom rank 32 x 5 = 160 rows, (160, 512) and (32, 512) as
# beam's and the full model's rows above
DEMO_MESHES = {"karel": (2, 2), "vizdoom": (1, 5)}
DEMO_SHAPES = [(BATCH // 2 * SPLIT.k // 2, 48), (BATCH // 2 * SPLIT.k // 2,
                                                 512),
               (BATCH * VZD_K // 5, 432)]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# HBM bytes/s, and FLOP/s of the tensor cores' TF32 and bf16 products. The
# f32 kernel takes three TF32 products per f32 product (3xTF32 split).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 495e12, torch.bfloat16: 989e12}
PASSES = {torch.float32: 3, torch.bfloat16: 1}
# the model on the card vs the plain path on the CPU, same weights: f32
# sums in other orders through 2*T + L LSTM steps
MODEL_ATOL = 1e-3
TRAIN_STEPS, TRAIN_LOG_STEP = 20, 10
# one train step's gradients, card vs CPU and kernel vs plain step, same
# weights and batch: per parameter, max |diff| <= GRAD_RTOL * max |g| +
# GRAD_ATOL. f32 sums in other orders (cuDNN, cuBLAS, the kernel's 3xTF32
# products) through 4*T + L LSTM steps and back; GRAD_ATOL covers the
# biases that feed BatchNorm (per_embed's, whose gradient is 0 in exact
# arithmetic, and the rn_pool FCs'), whose gradients are sums of terms
# that nearly cancel: small, with the absolute f32 error of the sum.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
LOSS_ATOL, NORM_RTOL = 1e-4, 1e-4
F32_TOL = dict(loss_atol=LOSS_ATOL, norm_rtol=NORM_RTOL, grad_rtol=GRAD_RTOL,
               grad_atol=GRAD_ATOL, global_rtol=1e-3)
# the same comparisons of a bf16 step. Two correct bf16 programs round at
# other points (cuBLAS or cuDNN against the CPU's loops, the kernel's f32
# gates on the card against the plain version's), and a flipped bf16
# rounding (2^-8 relative) of one activation moves everything after it:
# they lie about as far apart as either lies from the f32 step (on the CPU,
# the port against JAX: 1.0e-2 of the gradient's global norm,
# tests/test_torch_bf16.py). A leaf may miss by BF16_TOL["grad_rtol"] of its
# largest element (the biases that feed BatchNorm are sums of terms that
# nearly cancel); the whole gradient by BF16_TOL["global_rtol"] of its norm.
BF16_TOL = dict(loss_atol=5e-3, norm_rtol=5e-3, grad_rtol=0.35,
                grad_atol=1e-4, global_rtol=0.02)
STEP_TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
BF16_FLAGS = ("--compute_dtype", "bfloat16")
# bf16 train runs: steps, log window, and a checkpoint every BF16_CKPT steps
BF16_STEPS, BF16_LOG_STEP, BF16_CKPT = 20, 10, 10
BF16_VZD_STEPS, BF16_VZD_LOG_STEP = 10, 5
BF16_INDUCTION_STEPS, BF16_INDUCTION_LOG_STEP = 20, 10
# greedy and beam choices, card vs CPU in bf16: the two sides may round a
# logit up and its rival down, so a greedy choice is held to the CPU's only
# where the CPU's top two lie BF16_TIE_ULPS bf16 ulps of the larger apart
# (program logits of 4 to 8: 0.125; the action decoder's, under 1: 0.016),
# and a beam step's where the top K + 1 scores (f32 sums of bf16
# log-probabilities of 2 to 8) lie BF16_TIE_GAP apart. A model of 20 steps
# has a closer choice in nearly every row of 45 steps, so the card decodes
# along the CPU's prefix (ChoiceTape) and every step counts on its own; at
# least BF16_MIN_CLEAR of the choices of each kind must be that clear.
# Teacher-forced logits within half the gap (read: 0.031, one ulp).
# Decoded freely, every row's best beam score within BF16_SCORE_ATOL (sums
# of 45 log-probabilities; read: 0.70).
BF16_TIE_ULPS, BF16_TIE_GAP = 4, 0.125
BF16_MIN_CLEAR, BF16_SCORE_ATOL = 0.25, 1.0
GRAD_ITEMS = 8  # items of the card-vs-CPU step
FAMILIES = ("synthesis_baseline", "summarizer", "induction_baseline")
BASELINE_STEPS, BASELINE_LOG_STEP = 10, 5
TIMING_REPS = 2  # of the turns kernel, plain, plain, kernel
# decode mode -> eval batches (a parsed program runs to its call budget in
# the VM, so the constrained modes' batches are the long ones)
DECODE_MODES = {"beam": N_BATCHES, "syntax_greedy": 1, "syntax_sample": 1}
# beams card vs CPU: scores within SCORE_ATOL, on the rows where no beam
# choice (the top K + 1 candidates of any step) lies within TIE_GAP of a
# tie, since f32 sums in other orders may break such a tie either way
# (the model's logits differ by about 1e-6 between the two, PERF.md)
SCORE_ATOL, TIE_GAP = 1e-3, 1e-4
SS_STEPS, SS_LOG_STEP, SS_DECAY = 10, 5, 20
# exact resume: runs of RESUME_STEPS steps, one stopped halfway
RESUME_STEPS = 4
PROFILE_STEPS = 1  # profiled train steps in each mode or dtype
# the ViZDoom split: VZD_SHARDS generator runs of VZD_PER_SHARD programs
# each (seeds SEED, SEED + 1, ...), of which the first VZD_TRAIN distinct
# programs train and the next VZD_TEST evaluate
VZD_SHARDS, VZD_PER_SHARD = 8, 16
VZD_WORKERS = 4  # generator processes, beside the phases before ViZDoom's
VZD_TRAIN, VZD_TEST = 64, 32
VZD_STEPS, VZD_LOG_STEP, VZD_EVAL_BATCHES = 10, 5, 1
VZD_STAGE_STEPS, VZD_STAGE2_BATCH = 4, 8
# the data phase: streamed train runs (Karel, ViZDoom), the streamed and the
# device-cache loop timed in turns (runs of DATA_TURN_STEPS, the rate over
# the steps after the first log line), and one run of PROFILED_RUN_STEPS
# steps that profiles step 1 and writes the sample PNGs of step 0
DATA_STEPS, DATA_LOG_STEP = 20, 10
DATA_VZD_STEPS, DATA_VZD_LOG_STEP = 10, 5
DATA_TURN_STEPS, DATA_TURN_LOG_STEP = 20, 10
PROFILED_RUN_STEPS = 2
KERNEL_NAME = "fused_lstm_step_kernel"  # the __global__ in fused_lstm.cu
# the recipe phase: stage S's runner (cli/recipe_cli.py) at full width on a
# generated three-way split, in one process and staged through its carry
RECIPE_SPLIT = GeneratorConfig(num_train=96, num_test=40, num_val=40,
                               seed=SEED)
RECIPE = dict(max_steps=40, ckpt_save_step=10, test_sample_step=10,
              log_step=10, val_steps=(20, 30, 40), val_batches=2)
RECIPE_STAGE_AT = 20


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def timed(label, phase, /, *args, **kwargs):
    """phase(*args, **kwargs), with its seconds printed."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def check_entry(cfg, what):
    """Every kernel launch since the counts were set to 0 took the entry of
    cfg.compute_dtype (d2p_fused_lstm_step_f32 or _bf16)."""
    by_dtype = fused_lstm.fused_lstm_step.launches_by_dtype
    want = COMPUTE_DTYPES[cfg.compute_dtype]
    check(by_dtype[want] == fused_lstm.fused_lstm_step.launches
          and all(n == 0 for d, n in by_dtype.items() if d != want),
          f"{what}: launches by dtype {by_dtype}, all expected on {want}")


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
                     + VIZDOOM_SHAPES + DP_SHAPES + DEMO_SHAPES
                     + RECIPE_EVAL_SHAPES):
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
    fused_lstm.reset_launches()
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


def compare_grads(what, a, b, tol=F32_TOL, gate=True):
    """Largest |diff| of loss, grad norm and gradients between two
    step_grads results, and the global norm of the gradients' difference
    over the gradient's; with `gate`, checked against the tolerances `tol`
    (F32_TOL or BF16_TOL)."""
    loss_err = abs(a[0] - b[0])
    norm_err = abs(a[1] - b[1]) / abs(b[1])
    errs = {name: ((a[2][name] - g).abs().max().item(),
                   tol["grad_rtol"] * g.abs().max().item()
                   + tol["grad_atol"])
            for name, g in b[2].items()}
    worst = max(errs, key=lambda n: errs[n][0] / errs[n][1])
    ratio = errs[worst][0] / errs[worst][1]
    global_err = math.sqrt(sum(((a[2][n] - g).double() ** 2).sum().item()
                               for n, g in b[2].items())) / abs(b[1])
    out = {"loss_abs_diff": loss_err, "grad_norm_rel_diff": norm_err,
           "max_grad_abs_diff": max(e for e, _ in errs.values()),
           "worst_grad": worst, "worst_grad_abs_diff": errs[worst][0],
           "worst_grad_over_bound": ratio,
           "global_grad_rel_diff": global_err}
    print(f"{what} " + json.dumps(out), flush=True)
    if not gate:
        return out
    check(loss_err <= tol["loss_atol"], f"{what}: loss differs by {loss_err}")
    check(norm_err <= tol["norm_rtol"],
          f"{what}: grad norm differs by {norm_err}")
    check(ratio <= 1.0, f"{what}: gradient of {worst} differs by "
          f"{errs[worst][0]}, over {tol['grad_rtol']} * max|g| + "
          f"{tol['grad_atol']}")
    check(global_err <= tol["global_rtol"], f"{what}: the gradients differ "
          f"by {global_err} of their global norm")
    return out


def step_times(trainer, batch, cfg=None):
    """Seconds of forward, backward and optimizer of one train step (of
    `cfg`, default the trainer's), each ended by a synchronise."""
    state, cfg = trainer.state, cfg or trainer.cfg

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
                 test_sample_step=None, extra_flags=(), ckpt_save_step=None):
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
        "--ckpt_save_step", str(ckpt_save_step or steps), *extra_flags])


def train_phase(split, model_name="full", steps=TRAIN_STEPS,
                log_step=TRAIN_LOG_STEP, compare_plain=True,
                time_steps=True, name=None, extra_flags=(),
                check_falling=True, dataset_type="karel", num_k=None,
                test_split=None, eval_batches=N_BATCHES, ckpt_save_step=None,
                after=None):
    """Train `model_name` through the Trainer (with `extra_flags`) on
    `split`, check launches (their count and their dtype's entry), loss
    and one step's gradients (tolerances by the run's compute dtype),
    evaluate the checkpoint through the Evaler on `test_split` (default
    `split`). `after(trainer)` may add its own readings to the summary."""
    name = name or model_name
    tag = "train" if name == "full" else name
    num_k = num_k or SPLIT.k
    test_split = test_split or split
    train_dir = os.path.join(OUT_DIR, "train_" + name)
    shutil.rmtree(train_dir, ignore_errors=True)
    args = trainer_args(train_dir, steps, log_step, model_name, dataset_type,
                        num_k, extra_flags=extra_flags,
                        ckpt_save_step=ckpt_save_step)
    trainer = Trainer(args, split, test_split, device=args.device)
    cfg = trainer.cfg
    tol = STEP_TOL[cfg.compute_dtype]
    per_step, per_sample = lstm_launches(cfg)
    losses = []
    train_step = trainer.train_step

    def recorded(batch):  # keeps each step's loss on the card: no sync
        report = train_step(batch)
        losses.append(report["loss"])
        return report

    trainer.train_step = recorded
    fused_lstm.reset_launches()
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
    check_entry(cfg, f"{name} training")
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
        cpu_model, cfg, to_device(batch, "cpu"), **kw_cpu), tol)
    vs_plain = vs_f32 = None
    if compare_plain:
        with mock.patch.object(fused_lstm, "fused_lstm_step",
                               fused_lstm.lstm_step_ref):
            plain = step_grads(trainer.model, cfg, card, **kw_card)
        vs_plain = compare_grads(f"{tag}: kernel vs plain step", on_card,
                                 plain, tol)
    if cfg.compute_dtype != "float32":  # a reading, not a gate
        vs_f32 = compare_grads(
            f"{tag}: {cfg.compute_dtype} vs float32 step on the card",
            on_card, step_grads(
                trainer.model, dataclasses.replace(
                    cfg, compute_dtype="float32"), card, **kw_card),
            tol, gate=False)
    for what, tensors in (
            ("parameter", trainer.model.parameters()),
            ("buffer", trainer.model.buffers()),
            ("Adam moment", (m for st in trainer.state.optimizer.state.values()
                             for k, m in st.items() if k != "step")),
            ("checkpointed tensor", checkpoint.model_state_dict(
                checkpoint.load(ckpt)).values())):
        check(all(t.dtype in (torch.float32, torch.int64) for t in tensors),
              f"{name}: a {what} is not float32")

    eval_args = parse_args([
        "--model", model_name, "--dataset_type", dataset_type,
        "--dataset_path", "in-memory", "--checkpoint", ckpt,
        "--num_k", str(num_k), "--batch_size", str(BATCH),
        "--num_lstm_cell_units", str(UNITS), "--cell_impl", "pallas",
        "--max_steps", str(eval_batches), "--quiet", "--no_write_summary",
        "--device", DEVICE, "--compute_dtype", cfg.compute_dtype])
    evaler = Evaler(eval_args, test_split, device=eval_args.device)
    for key, t in trainer.model.state_dict().items():
        check(torch.equal(evaler.model.state_dict()[key], t),
              f"the Evaler's {key} is not the trained one")
    fused_lstm.reset_launches()
    loss, acc, hist = evaler.eval_run()
    eval_launches = fused_lstm.fused_lstm_step.launches
    check(eval_launches == eval_batches * per_sample,
          f"{name}: {eval_launches} kernel launches in {eval_batches} "
          f"eval batches, expected {eval_batches} x {per_sample}")
    check_entry(cfg, f"{name} eval")
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
        "card_vs_cpu": vs_cpu, "kernel_vs_plain": vs_plain,
        "compute_dtype": cfg.compute_dtype}
    if vs_f32:
        summary["vs_f32_step"] = vs_f32
    if time_steps:
        summary["step_s"] = time_train_steps(trainer, trainer.cache.batch(0))
    if after:
        summary.update(after(trainer))
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


def decode_evaler(split, ckpt, mode, batches):
    """The Evaler of the trained full model in decode mode `mode` (beam:
    K = BEAM_WIDTH, with --execution_rerank) over `batches` batches."""
    flags = ["--model", "full", "--dataset_path", "in-memory",
             "--checkpoint", ckpt, "--num_k", str(SPLIT.k),
             "--batch_size", str(BATCH), "--num_lstm_cell_units", str(UNITS),
             "--cell_impl", "pallas", "--max_steps", str(batches),
             "--quiet", "--no_write_summary", "--device", DEVICE,
             "--unroll_type", mode, "--beam_width", str(BEAM_WIDTH)]
    if mode == "beam":
        flags.append("--execution_rerank")
    args = parse_args(flags)
    return Evaler(args, split, device=args.device)


class ChoiceGaps:
    """Stands in for torch.argmax and torch.topk while a model decodes a
    batch of `rows` programs: per row, the smallest gap of any
    choice made over a (rows, ...) input (argmax: its top two; topk: among
    the top k + 1, the choices and the first one dropped). The program
    decoder's greedy, constrained and sampled ids and beam search's choices
    are such calls; the action decoder's run over rows x k."""

    def __init__(self, rows):
        self.rows, self.gaps = rows, None
        self._argmax, self._topk = torch.argmax, torch.topk

    def _note(self, x, k, dim):
        if x.dim() < 2 or x.shape[0] != self.rows or x.shape[dim] <= k:
            return
        top = self._topk(x.float(), k + 1, dim=dim).values
        gap = (top.narrow(dim, 0, k) - top.narrow(dim, 1, k)).amin(dim=dim)
        gap = gap.reshape(self.rows, -1).amin(dim=1)
        self.gaps = gap if self.gaps is None else torch.minimum(self.gaps,
                                                                gap)

    def argmax(self, x, dim=None, keepdim=False):
        self._note(x, 1, -1 if dim is None else dim)
        return self._argmax(x, dim=dim, keepdim=keepdim)

    def topk(self, x, k, dim=-1, **kw):
        self._note(x, k, dim)
        return self._topk(x, k, dim=dim, **kw)

    @contextlib.contextmanager
    def patched(self):
        """Inside the block, the model's forward (train/step.py:
        compute_call) decodes under the stand-ins; the objective's own
        argmax (over one-hot labels, zero past a program's end) is not a
        choice."""
        real = step_module.compute_call

        def compute_call(*args, **kwargs):
            with mock.patch.object(torch, "argmax", self.argmax), \
                    mock.patch.object(torch, "topk", self.topk):
                return real(*args, **kwargs)

        with mock.patch.object(step_module, "compute_call", compute_call):
            yield self


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


def planted_rerank(evaler, raw, batch, out):
    """With the ground truth planted as beam 2 of the card's beams `out`,
    the rerank's pick reproduces every seen demo -> picks per beam."""
    tokens = out["beam_tokens"].cpu().numpy().copy()
    lengths = out["beam_lengths"].cpu().numpy().copy()
    tokens[:, 2] = raw["program_tokens"]
    lengths[:, 2] = raw["program_len"][:, 0]
    pick = evaler.scorer.rerank_pick(tokens, lengths, batch)
    picked = np.arange(BATCH)
    nc, _ = evaler.scorer.execution_compact(
        tokens[picked, pick], lengths[picked, pick],
        np.zeros(BATCH, np.float32), batch)
    check((nc == evaler.cfg.k).all(), "a reranked beam does not reproduce "
          "its seen demos with the ground truth planted as beam 2")
    return np.bincount(pick, minlength=BEAM_WIDTH).tolist()


def beam_checks(evaler, split):
    """On the first batch, in f32: K = 1 beam search vs greedy on the card;
    the beams on the card vs the CPU on the rows with no beam choice within
    TIE_GAP of a tie; the planted rerank."""
    cfg, model, dev = evaler.cfg, evaler.model, evaler.device
    raw = split.get_batch_compact(split.ids[:BATCH])
    batch = to_device(raw, dev)
    k1_beam_is_greedy(model, cfg, batch)

    with torch.no_grad():
        out_k = model(expand_batch(batch, cfg), decode_mode="beam")
        cpu_model = FullModel(cfg)
        cpu_model.load_state_dict(model.state_dict())
        gaps = ChoiceGaps(BATCH)
        with mock.patch.object(torch, "topk", gaps.topk):
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
    return {"k1_equals_greedy": True, "cpu_rows_compared": n_rows,
            "cpu_score_max_abs_diff": score_err,
            "planted_picks": planted_rerank(evaler, raw, batch, out_k)}


def decode_phase(split, ckpt):
    """Evaluate the trained full model's checkpoint in each decode mode."""
    results = {}
    for mode, batches in DECODE_MODES.items():
        evaler = decode_evaler(split, ckpt, mode, batches)
        per_batch = lstm_launches(evaler.cfg)[1]
        shapes = {}  # (B, D) of the cells' launches -> the first's plan

        def record(cell, inputs, output):
            shapes.setdefault(tuple(inputs[1].shape), fused_lstm.last_plan())

        hooks = [m.register_forward_hook(record)
                 for m in evaler.model.modules()
                 if isinstance(m, fused_lstm.FusedLSTMCell)]
        fused_lstm.reset_launches()
        loss, acc, hist = evaler.eval_run()
        launches = fused_lstm.fused_lstm_step.launches
        for hook in hooks:
            hook.remove()
        check(launches == batches * per_batch,
              f"{mode}: {launches} kernel launches in {batches} batches, "
              f"expected {batches} x {per_batch}")
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
            per_step[mode], _ = profile_steps(trainer.train_step, batch,
                                              steps)
        finally:
            torch.use_deterministic_algorithms(True)
    on, off = per_step[True], per_step[False]
    return {"on_us": sum(on.values()), "off_us": sum(off.values()),
            "ops": most_moved(on, off, top)}


def profile_steps(step, batch, steps):
    """`steps` profiled calls of step(batch) after one unprofiled call ->
    ({kernel: device µs a call}, kernels launched a call)."""
    step(batch)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
    # the kernels' rows only: an operator's row repeats the device time of
    # the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return ({e.key: e.self_device_time_total / steps for e in rows},
            sum(e.count for e in rows) / steps)


def most_moved(a, b, top):
    """[[kernel, µs in a, µs in b], ...] of the `top` kernels whose device
    time a call moves most between two profile_steps results."""
    names = sorted(set(a) | set(b),
                   key=lambda n: -abs(a.get(n, 0) - b.get(n, 0)))
    return [[n[:120], a.get(n, 0), b.get(n, 0)] for n in names[:top]]


def dtype_readings(trainer, eval_batch, steps=PROFILE_STEPS, top=8):
    """bf16 beside f32 on one trainer's weights, in turns bf16, f32, f32,
    bf16: the train step's forward / backward / optimizer seconds
    (step_times), a profile of its device time and kernel count
    (profile_steps), and the eval step's seconds on `eval_batch` (greedy
    forward and objective; no scoring). The steps update the weights."""
    cfgs = {d: dataclasses.replace(trainer.cfg, compute_dtype=d)
            for d in ("bfloat16", "float32")}
    name = trainer.cfg.model
    batch = trainer.cache.batch(0)
    eval_steps = {d: make_eval_step(trainer.model, c, name)
                  for d, c in cfgs.items()}
    train_steps = {d: make_train_step(trainer.state, c, name)
                   for d, c in cfgs.items()}
    times = {d: [] for d in cfgs}
    evals = {d: [] for d in cfgs}
    for d in ("bfloat16", "float32", "float32", "bfloat16"):
        step_times(trainer, batch, cfgs[d])  # a warm-up step
        times[d] += [step_times(trainer, batch, cfgs[d])
                     for _ in range(steps)]
        eval_steps[d](eval_batch)
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_steps[d](eval_batch)
            torch.cuda.synchronize()
            evals[d].append(time.perf_counter() - t0)
    profiles = {d: profile_steps(train_steps[d], batch, steps) for d in cfgs}
    bf16, f32 = profiles["bfloat16"], profiles["float32"]
    return {"card": CARD,
            "step_s": {d: {k: float(np.median([r[k] for r in rs]))
                           for k in rs[0]} for d, rs in times.items()},
            "eval_forward_s": {d: float(np.median(v))
                               for d, v in evals.items()},
            "step_device_us": {"bfloat16": sum(bf16[0].values()),
                               "float32": sum(f32[0].values())},
            "step_kernels": {"bfloat16": bf16[1], "float32": f32[1]},
            "ops_bf16_f32": most_moved(bf16[0], f32[0], top)}


def resume_run(tag, split, test_split, dataset_type, num_k, steps, name,
               max_steps, target=None, deterministic=True):
    """One run of resume_phase: a Trainer of `steps`-step runs in
    <OUT_DIR>/resume_<tag>_<name> trained `max_steps` steps (a relaunch,
    with the killed run's stage `target`, resumes from the directory's
    checkpoint) -> (train_dir, trainer)."""
    train_dir = os.path.join(OUT_DIR, f"resume_{tag}_{name}")
    if target is None:
        shutil.rmtree(train_dir, ignore_errors=True)
    args = trainer_args(train_dir, steps, steps // 2,
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


def resumed_equal(tag, run, steps):
    """Runs a and b of `steps` steps and run c stopped at steps // 2 and
    resumed by a new Trainer (`run(name, max_steps, target)`: resume_run
    with the rest bound) -> namespace of the run dirs, run a's trainer and
    checkpoint, and whether b and the resumed c equal a bit for bit."""
    dirs = {}
    dirs["a"], trainer_a = run("a", steps)
    dirs["b"], _ = run("b", steps)
    dirs["c"], _ = run("c", steps // 2)
    _, resumed = run("c", steps, target=steps)
    check(resumed._auto_resumed, f"{tag}: the relaunch did not resume")
    first, b, c = (checkpoint.load(checkpoint.checkpoint_path(dirs[n], steps))
                   for n in "abc")
    return types.SimpleNamespace(
        dirs=dirs, trainer=trainer_a, first=first,
        same_runs=equal_states(first, b), same_resumed=equal_states(first, c))


def resume_phase(tag, split, test_split, dataset_type="karel",
                 num_k=None, steps=RESUME_STEPS, profile=False):
    """Exact resume on the card (deterministic mode, which main turns on
    as the entry points do): two runs of `steps` steps from one seed, and a
    run stopped at steps // 2 and resumed by a new Trainer, must all save
    the same checkpoint bit for bit. Then the same run with deterministic
    algorithms off for its steps, for the mode's cost in s/step, and with
    `profile` the device time of a step in each mode (mode_profile)."""
    log_step = steps // 2
    run = functools.partial(resume_run, tag, split, test_split, dataset_type,
                            num_k, steps)
    runs = resumed_equal(tag, run, steps)
    dir_d, _ = run("d", steps, deterministic=False)
    evals = eval_modes(checkpoint.checkpoint_path(runs.dirs["a"], steps),
                       test_split, dataset_type, num_k or SPLIT.k)
    res = {"card": CARD, "steps": steps,
           "two_runs_bitwise_equal": runs.same_runs,
           "resumed_run_bitwise_equal": runs.same_resumed,
           "deterministic_s_per_step": rate(runs.dirs["a"], steps, log_step),
           "deterministic_s_per_step_b": rate(runs.dirs["b"], steps,
                                              log_step),
           "default_s_per_step": rate(dir_d, steps, log_step),
           "default_run_bitwise_equal": equal_states(
               runs.first, checkpoint.load(
                   checkpoint.checkpoint_path(dir_d, steps))),
           "eval_s_per_batch": evals}
    if profile:  # after the checkpoints: the profiled steps move trainer a
        res["step_device_profile"] = mode_profile(runs.trainer)
    print(f"resume_{tag} " + json.dumps(res), flush=True)
    check(runs.same_runs, f"{tag}: two runs from one seed differ on the card")
    check(runs.same_resumed, f"{tag}: the resumed run differs from the "
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
    workers = min(VZD_WORKERS, os.cpu_count() or 1)
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


def vizdoom_phase(train_split, test_split, gen_s):
    """The ViZDoom full model on the card at units 512, bs 32, k 25 on the
    splits of vizdoom_split: train through the Trainer, evaluate greedy and
    beam + rerank through the Evaler, hold the engine oracle, exact resume
    and the bs 32 -> 8 warm start."""
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
    fused_lstm.reset_launches()
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


class ChoiceTape:
    """Stands in for torch.argmax and torch.topk while a model decodes. On
    the CPU (`record`) it keeps every call's choice and whether it was
    clear: argmax (greedy ids, over bf16 logits), the top 2 lie at least
    `tie_ulps` bf16 ulps of the larger apart; topk (beam search, over f32
    sums of log-probabilities), the smallest gap among the top k + 1, the
    choices and the first one dropped, is at least `tie_gap`. On the card
    (`replay`) it takes the card's own choice of the same call, counts the
    rows where that differs from the CPU's although the CPU's was clear,
    and hands back the CPU's choice (topk: with the CPU's scores), so the
    card decodes on along the CPU's prefix and every step of every row is
    compared on its own: one near-tie costs its step, not the rest of its
    row."""

    def __init__(self, tie_ulps, tie_gap):
        self.tie_ulps, self.tie_gap = tie_ulps, tie_gap
        self.calls = []  # (kind, choice, values or None, clear rows)
        self.cursor = 0
        self.counts = {kind: {"choices": 0, "compared": 0, "mismatches": 0}
                       for kind in ("argmax", "topk")}
        self.value_err = 0.0
        self._argmax, self._topk = torch.argmax, torch.topk

    def record(self):
        return self._patched(self._record_argmax, self._record_topk)

    def replay(self):
        self.cursor = 0
        return self._patched(self._replay_argmax, self._replay_topk)

    @contextlib.contextmanager
    def _patched(self, argmax, topk):
        with mock.patch.object(torch, "argmax", argmax), \
                mock.patch.object(torch, "topk", topk):
            yield self

    def _record_argmax(self, x, dim):
        top = self._topk(x.float(), 2, dim=dim).values
        choice = self._argmax(x, dim=dim)
        first, second = top.select(dim, 0), top.select(dim, 1)
        # a bf16 value in [2^e, 2^(e+1)) has an ulp of 2^(e-7); below 2^-4
        # the ulp of 2^-4 stands in
        ulp = torch.exp2(torch.floor(torch.log2(
            first.abs().clamp_min(2.0 ** -4))) - 7)
        clear = (first - second) >= self.tie_ulps * ulp
        self.calls.append(("argmax", choice, None, clear))
        return choice

    def _record_topk(self, x, k, dim):
        top = self._topk(x.float(), k + 1, dim=dim).values
        values, choice = self._topk(x, k, dim=dim)
        clear = (top.narrow(dim, 0, k) - top.narrow(dim, 1, k)).amin(
            dim=dim) >= self.tie_gap
        self.calls.append(("topk", choice, values, clear))
        return values, choice

    def _next(self, kind, own):
        """The taped call that matches the card's call `own`; counts the
        rows where the card chose otherwise although the CPU's choice was
        clear."""
        taped_kind, choice, values, clear = self.calls[self.cursor]
        self.cursor += 1
        check(taped_kind == kind and choice.shape == own.shape,
              f"the card's {kind} call {self.cursor} is not the CPU's")
        same = own.cpu() == choice
        same = same if same.dim() == clear.dim() else same.all(dim=-1)
        counts = self.counts[kind]
        counts["choices"] += clear.numel()
        counts["compared"] += int(clear.sum())
        counts["mismatches"] += int((clear & ~same).sum())
        return choice.to(own.device), values

    def _replay_argmax(self, x, dim):
        return self._next("argmax", self._argmax(x, dim=dim))[0]

    def _replay_topk(self, x, k, dim):
        choice, values = self._next("topk", self._topk(x, k, dim=dim)[1])
        own = x.gather(dim, choice).float().cpu()
        self.value_err = max(self.value_err,
                             (own - values.float()).abs().max().item())
        return values.to(x.device, x.dtype), choice

    def summary(self):
        return dict(self.counts, topk_value_max_abs_diff=self.value_err)


def choices_card_vs_cpu(evaler, split, decode_mode="greedy"):
    """Every decode choice of the first batch (the program decoder's greedy
    ids or beam choices, the action decoder's greedy ids), the card
    (kernel) vs the CPU (plain) in the Evaler's compute dtype, step by step
    with the CPU's prefix forced on the card (ChoiceTape): wherever the
    CPU's choice is clear the card's own choice must be the same, and at
    least BF16_MIN_CLEAR of the choices of each kind must be that clear
    -> (readings, the CPU's outputs)."""
    cfg, model = evaler.cfg, evaler.model
    raw = split.get_batch_compact(split.ids[:BATCH])
    cpu_model = FullModel(cfg)
    cpu_model.load_state_dict(model.state_dict())
    on_cpu = expand_batch(to_device(raw, "cpu"), cfg)
    on_card = expand_batch(to_device(raw, evaler.device), cfg)
    tape = ChoiceTape(BF16_TIE_ULPS, BF16_TIE_GAP)
    with torch.no_grad():
        with tape.record():
            out_c = compute_call(cpu_model.eval(), cfg, on_cpu,
                                 decode_mode=decode_mode)
        with tape.replay():
            out_k = compute_call(model, cfg, on_card,
                                 decode_mode=decode_mode)
    check(tape.cursor == len(tape.calls),
          f"the card made {tape.cursor} choices, the CPU {len(tape.calls)}")
    res = tape.summary()
    what = f"{decode_mode} card vs CPU ({cfg.compute_dtype})"
    for kind, gap in (("argmax", f"{BF16_TIE_ULPS} bf16 ulps"),
                      ("topk", f"{BF16_TIE_GAP}")):
        n = res[kind]
        if not n["choices"]:
            continue
        print(f"{what}: {n['compared']} of {n['choices']} {kind} choices "
              f"are clear by {gap} on the CPU and compared with the card's "
              f"own, the CPU's prefix forced: {n['mismatches']} differ",
              flush=True)
        check(n["compared"] >= BF16_MIN_CLEAR * n["choices"],
              f"{what}: only {n['compared']} of {n['choices']} {kind} "
              f"choices are clear of a tie")
        check(n["mismatches"] == 0, f"{what}: {n['mismatches']} {kind} "
              f"choices differ between the card and the CPU outside ties")
    for key in ("greedy_program_tokens", "greedy_program_len",
                "greedy_action_tokens", "beam_tokens", "beam_lengths"):
        if key in out_c:
            check(torch.equal(out_k[key].cpu(), out_c[key]),
                  f"{what}: {key} differ along the forced prefix")
    err = (out_k["pred_program_logits"].float().cpu()
           - out_c["pred_program_logits"].float()).abs().max().item()
    print(f"{what}: teacher-forced program logits differ by at most "
          f"{err:.3g}; a step's beam scores by at most "
          f"{res['topk_value_max_abs_diff']:.3g}", flush=True)
    check(2 * err <= BF16_TIE_GAP, f"{what}: teacher-forced program logits "
          f"differ by {err}")
    return dict(res, pred_logits_max_abs_diff=err), out_c


def free_beams_vs_cpu(evaler, split, out_c):
    """The card's beams of the first batch decoded freely (no prefix
    forced), in the Evaler's compute dtype: every row's best beam score
    within BF16_SCORE_ATOL of the CPU's (`out_c`, of choices_card_vs_cpu);
    the planted rerank."""
    cfg = evaler.cfg
    raw = split.get_batch_compact(split.ids[:BATCH])
    batch = to_device(raw, evaler.device)
    with torch.no_grad():
        out_k = compute_call(evaler.model, cfg, expand_batch(batch, cfg),
                             decode_mode="beam")
    best_err = (out_k["beam_scores"].cpu().max(dim=1).values
                - out_c["beam_scores"].max(dim=1).values).abs().max().item()
    same = (out_k["beam_tokens"].cpu() == out_c["beam_tokens"]).all(
        dim=-1).all(dim=-1)
    print(f"beam card vs CPU ({cfg.compute_dtype}), decoded freely: best "
          f"beam scores of all {BATCH} rows differ by at most {best_err:.3g};"
          f" {int(same.sum())} rows decode the same {BEAM_WIDTH} beams",
          flush=True)
    check(best_err <= BF16_SCORE_ATOL, f"best beam scores differ by "
          f"{best_err} between the card and the CPU")
    return {"free_best_score_max_abs_diff": best_err,
            "free_rows_equal": int(same.sum()),
            "planted_picks": planted_rerank(evaler, raw, batch, out_k)}


def bf16_sweep(split, train_dir, mode):
    """`evaler_cli --sweep_steps` over the bf16 run's checkpoints in bf16,
    greedy or beam K = BEAM_WIDTH with --execution_rerank: one Evaler for
    both steps, one summary file a step, exact launches on the bf16 entry
    -> (the Evaler, readings)."""
    steps = list(range(BF16_CKPT, BF16_STEPS + 1, BF16_CKPT))
    summary = os.path.join(train_dir, f"sweep_{mode}.txt")
    flags = ["--model", "full", "--dataset_path", "in-memory",
             "--train_dir", train_dir, "--num_k", str(SPLIT.k),
             "--batch_size", str(BATCH), "--num_lstm_cell_units", str(UNITS),
             "--cell_impl", "pallas", "--max_steps", str(N_BATCHES),
             "--quiet", "--device", DEVICE, "--unroll_type", mode,
             "--sweep_steps", ",".join(map(str, steps)),
             "--summary_file", summary, *BF16_FLAGS]
    if mode == "beam":
        flags += ["--beam_width", str(BEAM_WIDTH), "--execution_rerank"]
    args = parse_args(flags)
    built = []
    init = Evaler.__init__

    def recording_init(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    fused_lstm.reset_launches()
    with mock.patch.object(evaler_module.Evaler, "__init__", recording_init):
        results = evaler_cli.run_sweep(args, split, DEVICE)
    launches = fused_lstm.fused_lstm_step.launches
    check(sorted(results) == steps, f"sweep {mode}: evaluated "
          f"{sorted(results)}, expected {steps}")
    check(len(built) == 1, f"sweep {mode}: {len(built)} Evalers were built")
    evaler = built[0]
    per_batch = lstm_launches(evaler.cfg)[1]
    check(launches == len(steps) * N_BATCHES * per_batch,
          f"sweep {mode}: {launches} launches, expected {len(steps)} x "
          f"{N_BATCHES} x {per_batch}")
    check_entry(evaler.cfg, f"sweep {mode}")
    for step in steps:
        path = f"{summary}.{step}"
        check(os.path.exists(path) and f"ckpt/{step}.pt" in open(path).read(),
              f"sweep {mode}: no summary of step {step} at {path}")
        check(all(np.isfinite(v).all() for d in results[step]
                  for v in d.values()), f"sweep {mode}: non-finite report")
    check(evaler.checkpoint.endswith(f"{steps[-1]}.pt"),
          f"sweep {mode}: the Evaler ended at {evaler.checkpoint}")
    t = evaler.timings
    return evaler, {
        "mode": mode, "steps": steps, "launches": launches,
        "s_per_batch": t["batch"], "forward_s": t["forward"],
        "vm_s": t["vm"],
        "loss": {s: results[s][0]["loss"] for s in steps},
        "greedy_program_syntax_acc": {
            s: results[s][1]["greedy_program_syntax_acc"] for s in steps}}


def tool_agrees_with_scorer(evaler, split):
    """tools/eval_execution.py:batch_check on the card over one batch of
    ground-truth programs and of the model's greedy programs: the number of
    seen demos each program reproduces equals the Evaler's scorer's."""
    cfg, vocab = evaler.cfg, evaler.vocab
    raw = split.get_batch_compact(split.ids[:BATCH])
    batch = to_device(raw, evaler.device)
    _, evals = evaler.eval_step(batch)
    full = expand_batch(batch, cfg)
    demos = list(full["s_h"].to(torch.uint8).cpu().numpy())
    demo_lens = raw["demo_len"].astype(np.int32)
    out = {}
    for what, tokens, lens in (
            ("ground_truth", raw["program_tokens"],
             raw["program_len"][:, 0].astype(int)),
            ("greedy", evals["greedy_tokens"].cpu().numpy(),
             evals["greedy_len"].cpu().numpy().astype(int))):
        programs = [vocab.intseq2str(t[:n]) for t, n in zip(tokens, lens)]
        checked = eval_execution.batch_check(
            programs, list(raw["id"]), demos, demo_lens, vocab, device=DEVICE)
        got = np.array([c.num_correct for c in checked])
        want, _ = evaler.scorer.execution_compact(
            torch.as_tensor(tokens, device=evaler.device),
            torch.as_tensor(lens, device=evaler.device),
            np.zeros(BATCH, np.float32), batch)
        check(np.array_equal(got, np.asarray(want).astype(int)),
              f"batch_check and the scorer disagree on the {what} programs: "
              f"{got.tolist()} vs {np.asarray(want).tolist()}")
        out[what] = {"all_correct": float((got == cfg.k).mean()),
                     "syntax": float(np.mean([c.syntax for c in checked]))}
    check(out["ground_truth"]["all_correct"] == 1.0,
          "batch_check: a ground-truth program misses a seen demo")
    return out


def induction_concat_step(split):
    """One bf16 train step of the induction baseline with the state
    features concatenated to its attention memory
    (ModelConfig.concat_state_feature_direct_prediction, no CLI flag): the
    variant the JAX package traces in bf16, which tests/test_torch_bf16.py
    holds against it on the CPU. Card (kernel) vs CPU (plain) within
    BF16_TOL, every launch on the bf16 entry."""
    args = trainer_args(os.path.join(OUT_DIR, "unused"), 1, 1,
                        "induction_baseline", extra_flags=BF16_FLAGS)
    cfg = dataclasses.replace(config_from_dataset(args, split),
                              concat_state_feature_direct_prediction=True)
    cpu_model = get_model_class(cfg.model)(cfg)
    init_parameters(cpu_model, torch.Generator().manual_seed(SEED))
    batch = fetch_batch(split, split.ids[:GRAD_ITEMS], "karel")
    fused_lstm.reset_launches()
    on_card = step_grads(copy.deepcopy(cpu_model).to(DEVICE), cfg,
                         to_device(batch, DEVICE))
    launches = fused_lstm.fused_lstm_step.launches
    check(launches == lstm_launches(cfg)[0], f"induction, concatenated "
          f"state features: {launches} launches in one step")
    check_entry(cfg, "induction, concatenated state features")
    return dict(compare_grads(
        "induction_bf16, concatenated state features: card vs CPU", on_card,
        step_grads(cpu_model, cfg, to_device(batch, "cpu")), BF16_TOL),
        launches=launches)


def bf16_phase(split, vizdoom_splits):
    """`--compute_dtype bfloat16` end to end on the card at units 512, bs
    32: train the Karel full model through the Trainer (two checkpoints),
    sweep the checkpoints with evaler_cli's --sweep_steps (greedy, then
    beam + rerank), re-score one batch with tools/eval_execution.py's
    batch_check, and train ViZDoom's full model and the induction baseline;
    every LSTM step on the kernel's bf16 entry."""
    eval_batch = to_device(split.get_batch_compact(split.ids[:BATCH]), DEVICE)
    train = timed(
        "bf16 train", train_phase,
        split, steps=BF16_STEPS, log_step=BF16_LOG_STEP, time_steps=False,
        name="full_bf16", extra_flags=BF16_FLAGS, ckpt_save_step=BF16_CKPT,
        after=lambda trainer: {"bf16_vs_f32": timed(
            "bf16 readings", dtype_readings, trainer, eval_batch)})
    train_dir = os.path.dirname(os.path.dirname(train["checkpoint"]))
    saved = checkpoint.checkpoint_steps(train_dir)
    check(saved == list(range(BF16_CKPT, BF16_STEPS + 1, BF16_CKPT)),
          f"bf16: checkpoints at {saved}")

    evaler, greedy = timed("bf16 greedy sweep", bf16_sweep, split, train_dir,
                           "greedy")
    greedy["card_vs_cpu"], _ = timed("bf16 greedy choices",
                                     choices_card_vs_cpu, evaler, split)
    seen, test, _ = ground_truth_execution(evaler, split, 1)
    check(seen == 1.0 and test == 1.0,
          "bf16: ground-truth programs do not reproduce their demos")
    tool = tool_agrees_with_scorer(evaler, split)
    print("bf16 sweep " + json.dumps(greedy), flush=True)
    beam_evaler, beam = timed("bf16 beam sweep", bf16_sweep, split,
                              train_dir, "beam")
    beam["card_vs_cpu"], cpu_beams = timed(
        "bf16 beam choices", choices_card_vs_cpu, beam_evaler, split, "beam")
    beam.update(free_beams_vs_cpu(beam_evaler, split, cpu_beams))
    print("bf16 sweep " + json.dumps(beam), flush=True)

    vz_train, vz_test, _ = vizdoom_splits
    vz_batch = to_device(fetch_batch(vz_test, vz_test.ids[:BATCH], "vizdoom"),
                         DEVICE)
    vizdoom = timed(
        "bf16 vizdoom", train_phase,
        vz_train, steps=BF16_VZD_STEPS, log_step=BF16_VZD_LOG_STEP,
        time_steps=False, compare_plain=False, name="vizdoom_bf16",
        dataset_type="vizdoom", num_k=VZD_K, test_split=vz_test,
        eval_batches=VZD_EVAL_BATCHES, extra_flags=BF16_FLAGS,
        after=lambda trainer: {"bf16_vs_f32": timed(
            "bf16 vizdoom readings", dtype_readings, trainer, vz_batch)})
    induction = timed(
        "bf16 induction", train_phase,
        split, "induction_baseline", BF16_INDUCTION_STEPS,
        BF16_INDUCTION_LOG_STEP, time_steps=False, name="induction_bf16",
        extra_flags=BF16_FLAGS)
    res = {"card": CARD, "tool_vs_scorer": tool,
           "induction_concat_step": induction_concat_step(split),
           "ground_truth_execution": {"seen": seen, "unseen": test},
           "launches": {"train": train["launches"],
                        "sweep_greedy": greedy["launches"],
                        "sweep_beam": beam["launches"],
                        "vizdoom_train": vizdoom["launches"],
                        "induction_train": induction["launches"]}}
    print("bf16 " + json.dumps(res), flush=True)
    return res


@contextlib.contextmanager
def streaming(on=True):
    """D2P_KAREL_DEVICE_CACHE and D2P_DOOM_DEVICE_CACHE set to "0" (the
    Trainer streams its train split) inside the block, as they were
    after it."""
    names = ("D2P_KAREL_DEVICE_CACHE", "D2P_DOOM_DEVICE_CACHE")
    before = {n: os.environ.get(n) for n in names}
    for n in names:
        os.environ[n] = "0" if on else "1"
    try:
        yield
    finally:
        for n, v in before.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


def host_cpu():
    """The host's CPU (model name, else its architecture) and core count,
    for host-side rates."""
    model = platform.machine()
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    return f"{model}, {os.cpu_count()} cores"


def generation_check(split):
    """Build the native engine, generate SPLIT's programs with both
    backends of the Karel generator (in memory: the card's machine has no
    h5py) and check that the records are equal, array for array, and that
    their compact form is `split` (data/karel_memory.py's, which the other
    phases train and evaluate on)."""
    path, build_s, _ = native.build()
    cfg = SPLIT.generator_config()
    records, rates = {}, {}
    for backend in ("native", "python"):
        t0 = time.perf_counter()
        records[backend] = list(generate_records(cfg, backend,
                                                 progress_every=0))
        rates[backend] = SPLIT.num_programs / (time.perf_counter() - t0)
    a, b = records["native"], records["python"]
    check(len(a) == len(b) == SPLIT.num_programs + 1,
          f"{len(a)} native and {len(b)} python records")
    for (id_a, ra), (id_b, rb) in zip(a, b):
        check(id_a == id_b and set(ra) == set(rb),
              f"native record {id_a} vs python {id_b}")
        for key in ra:
            check(np.array_equal(ra[key], rb[key])
                  and np.asarray(ra[key]).dtype == np.asarray(rb[key]).dtype,
                  f"{id_a}/{key}: native and python records differ")
    compact = split_from_records(a, SPLIT.max_program_len,
                                 SPLIT.max_demo_len)
    check(compact.ids == split.ids and set(compact.arr) == set(split.arr)
          and all(np.array_equal(compact.arr[k], v)
                  and compact.arr[k].dtype == v.dtype
                  for k, v in split.arr.items()),
          "the native records' compact form is not the in-memory split")
    res = {"library": os.path.relpath(path, ROOT), "build_s": build_s,
           "programs": SPLIT.num_programs, "host": host_cpu(),
           "native_programs_per_s": rates["native"],
           "python_programs_per_s": rates["python"],
           "records_equal": True, "compact_equals_in_memory_split": True}
    print("data generation " + json.dumps(res), flush=True)
    return res


def data_waits(train_dir):
    """sec_data_wait of every train row of a run's metrics.jsonl."""
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["sec_data_wait"] for r in rows if r["split"] == "train"]


# batches of the streamed-copy check: more than the pipeline queues (4), so
# later copies land in memory that earlier batches freed
STREAM_CHECK_BATCHES = 8


def check_streamed_batches(trainer, split, name):
    """The contents of streamed batches on the card. A fresh BatchPipeline
    with the trainer's seed, drop keys and wire hands out
    STREAM_CHECK_BATCHES batches through next(); before each batch is copied
    on the current stream and freed, that stream is kept busy with a chain
    of matmuls, so a copy that did not wait for the pipeline's event, or
    memory handed to a later batch before the current stream had read it,
    shows as a wrong array. Then the pipeline's worker job runs alone on
    the main thread for 3 batches (`make_ms`: host ms to make and ship one).
    Every batch is held against the split's host batch of the same ids,
    array for array (values and dtypes), and on Karel also against
    KarelDeviceCache's gather of the same rows on the card."""
    karel = trainer.cfg.dataset_type == "karel"
    drop = trainer.pipe_train.drop_keys
    bs = trainer.args.batch_size
    pipe = BatchPipeline(split, bs, seed=trainer.args.seed, device=DEVICE,
                         drop_keys=drop, compact=karel)
    busy = torch.ones(4096, 4096, device=DEVICE)

    def copy(batch):
        return {k: v.clone() if torch.is_tensor(v) else v
                for k, v in batch.items()}

    got, make_ms = [], []
    try:
        for _ in range(STREAM_CHECK_BATCHES):
            batch = next(pipe)
            x = busy
            for _ in range(4):
                x = (x @ busy) / 4096
            got.append(copy(batch))
            del batch
        for b in range(3):
            t0 = time.perf_counter()
            batch, event = pipe._load_batch(split.ids[b:b + bs])
            if event is not None:  # None on the CPU (a rehearsal)
                event.synchronize()
            make_ms.append((time.perf_counter() - t0) * 1e3)
            got.append(batch)
    finally:
        pipe.close()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    cache = (KarelDeviceCache(split, DEVICE, bs, trainer.args.seed,
                              include_test=not drop) if karel else None)
    for batch in got:
        ids = list(batch["id"])
        host = (split.get_batch_compact(ids) if karel
                else split.get_batch(ids))
        want = {k: np.ascontiguousarray(v) for k, v in host.items()
                if k not in drop and k != "id"}
        check(set(batch) - {"id"} == set(want),
              f"{name}: streamed keys {sorted(batch)}, expected {sorted(want)}")
        for key, v in want.items():
            t = batch[key]
            check(t.device == torch.device(DEVICE, t.device.index)
                  and t.dtype == torch.from_numpy(v).dtype
                  and np.array_equal(t.cpu().numpy(), v),
                  f"{name}: streamed {key} differs from the split's host "
                  f"batch of the same ids")
        if cache is not None:
            rows = torch.as_tensor([split.index[i] for i in ids],
                                   device=DEVICE)
            check(set(cache.data) == set(want)
                  and all(torch.equal(batch[k], v.index_select(0, rows))
                          for k, v in cache.data.items()),
                  f"{name}: a streamed batch differs from the device "
                  f"cache's gather of its rows")
    return {"batches_checked": len(got), "make_ms": make_ms}


def streamed_train(split, name, steps, log_step, dataset_type="karel",
                   num_k=None, test_split=None, eval_batches=N_BATCHES):
    """train_phase with the train split streamed (the Trainer builds no
    device cache), adding the bytes shipped a step, sec_data_wait, and
    check_streamed_batches' readings."""
    def after(trainer):
        pipe = trainer.pipe_train
        check(trainer.cache is None and pipe is not None,
              f"{name}: the trainer did not stream")
        check(pipe._pool._shutdown, f"{name}: the pipeline's workers still "
              f"run")
        return {"bytes_per_step": pipe.bytes_shipped / steps,
                **check_streamed_batches(trainer, split, name)}

    with streaming():
        res = train_phase(split, steps=steps, log_step=log_step,
                          compare_plain=False, time_steps=False, name=name,
                          dataset_type=dataset_type, num_k=num_k,
                          test_split=test_split, eval_batches=eval_batches,
                          after=after)
    res["sec_data_wait"] = data_waits(
        os.path.dirname(os.path.dirname(res["checkpoint"])))
    print(f"{name} data: bytes a step {res['bytes_per_step']:.0f}, "
          f"sec_data_wait {res['sec_data_wait']}, ms to make a batch "
          f"{res['make_ms']}, streamed batches equal to the split's: "
          f"{res['batches_checked']}", flush=True)
    return res


def loop_turns(split, test_split=None, dataset_type="karel", num_k=None,
               steps=DATA_TURN_STEPS, log_step=DATA_TURN_LOG_STEP):
    """Trainer s/step of the device-cache loop and of the streamed one, in
    turns cache, stream, stream, cache (runs of `steps` steps)."""
    rates = {"cache": [], "stream": []}
    waits = []
    for turn, mode in enumerate(("cache", "stream", "stream", "cache")):
        train_dir = os.path.join(OUT_DIR, f"turn_{dataset_type}_{turn}")
        shutil.rmtree(train_dir, ignore_errors=True)
        with streaming(mode == "stream"):
            trainer = Trainer(trainer_args(train_dir, steps, log_step,
                                           dataset_type=dataset_type,
                                           num_k=num_k),
                              split, test_split or split, device=DEVICE)
        check((trainer.cache is None) == (mode == "stream"),
              f"turn {turn}: the trainer did not take the {mode} loop")
        trainer.train(max_steps=steps)
        torch.cuda.synchronize()
        rates[mode].append(rate(train_dir, steps, log_step))
        if mode == "stream":
            waits += data_waits(train_dir)
    res = {"card": CARD, "dataset_type": dataset_type, "s_per_step": rates,
           "stream_sec_data_wait": waits,
           "median_s_per_step": {m: float(np.median(r))
                                 for m, r in rates.items()}}
    print("data turns " + json.dumps(res), flush=True)
    return res


def streamed_resume(tag, split, test_split, dataset_type="karel",
                    num_k=None, steps=RESUME_STEPS):
    """resume_phase's bitwise check on the streamed loop: two runs of
    `steps` steps and a run stopped at steps // 2 and resumed by a new
    Trainer (which fast-forwards its id stream) save equal checkpoints."""
    run = functools.partial(resume_run, f"stream_{tag}", split, test_split,
                            dataset_type, num_k, steps)
    with streaming():
        runs = resumed_equal(tag, run, steps)
    check(runs.trainer.pipe_train is not None, f"{tag}: not streamed")
    res = {"steps": steps, "two_runs_bitwise_equal": runs.same_runs,
           "resumed_run_bitwise_equal": runs.same_resumed}
    print(f"stream_resume_{tag} " + json.dumps(res), flush=True)
    check(runs.same_runs, f"{tag}: two streamed runs from one seed differ "
          f"on the card")
    check(runs.same_resumed, f"{tag}: the resumed streamed run differs from "
          f"the uninterrupted one")
    return res


def profiled_run(split):
    """A streamed Karel run of PROFILED_RUN_STEPS steps with
    --profile_steps 1 --profile_start 1 --sample_images: the Chrome trace
    of step 1 must parse and hold exactly one train step's kernel launches
    (125 events named KERNEL_NAME), and the test-sample eval of step 0 must
    write four PNGs that decode to their expected sizes."""
    train_dir = os.path.join(OUT_DIR, "profiled")
    shutil.rmtree(train_dir, ignore_errors=True)
    args = trainer_args(train_dir, PROFILED_RUN_STEPS, PROFILED_RUN_STEPS,
                        extra_flags=("--profile_steps", "1",
                                     "--profile_start", "1",
                                     "--sample_images"))
    with streaming():
        trainer = Trainer(args, split, split, device=args.device)
    cfg = trainer.cfg
    per_step, per_sample = lstm_launches(cfg)
    fused_lstm.reset_launches()
    t0 = time.perf_counter()
    trainer.train(max_steps=PROFILED_RUN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_lstm.fused_lstm_step.launches
    check(launches == PROFILED_RUN_STEPS * per_step + per_sample,
          f"profiled run: {launches} launches, expected "
          f"{PROFILED_RUN_STEPS} x {per_step} + {per_sample}")
    trace = os.path.join(train_dir, "profile", "trace_steps_1-2.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    lstm = [e for e in kernels if KERNEL_NAME in e.get("name", "")]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    check(len(lstm) == per_step,
          f"the profiled step's trace names {KERNEL_NAME} {len(lstm)} "
          f"times, expected {per_step}")

    V, L = cfg.dim_program_token, cfg.max_program_len
    T, A, P = cfg.max_demo_len, cfg.action_space, cfg.per_dim
    pngs = {}
    for kind in ("program", "demo", "action", "per"):
        path = os.path.join(train_dir, "samples", f"step_0_{kind}.png")
        pngs[kind] = list(read_png(path).shape)
    t_demo = pngs["demo"][1] // 80  # states of the first demo drawn
    want = {"program": [3 * (3 * V + 4), 3 * L],
            "demo": [80, 80 * t_demo, 3], "action": [8 * A, 8 * T, 3],
            "per": [8 * (2 * P + 1), 8 * t_demo]}
    check(pngs == want and 2 <= t_demo <= T,
          f"sample PNGs {pngs}, expected {want}")
    res = {"card": CARD, "seconds": seconds, "launches": launches,
           "trace_mb": os.path.getsize(trace) / 1e6,
           "trace_kernels": len(kernels), "trace_lstm_kernels": len(lstm),
           "trace_gpu_memcpy": len(copies),
           "lstm_device_us": sum(e.get("dur", 0) for e in lstm),
           "kernels_device_us": sum(e.get("dur", 0) for e in kernels),
           "png_shapes": pngs}
    print("profiled " + json.dumps(res), flush=True)
    return res


def data_phase(split, vizdoom_splits):
    """The data path on the card: the generator's two engines against each
    other and the in-memory split; streamed training (Karel and ViZDoom at
    full width, exact launches, a falling loss, gradients card vs CPU, the
    checkpoint evaluated), the streamed loop beside the device cache in
    turns, bitwise exact resume when streamed, and a profiled run that
    writes the sample PNGs."""
    vz_train, vz_test, _ = vizdoom_splits
    res = {"card": CARD,
           "generation": timed("data generation", generation_check, split)}
    res["karel"] = timed("data karel streamed", streamed_train, split,
                         "karel_streaming", DATA_STEPS, DATA_LOG_STEP)
    res["turns"] = timed("data turns", loop_turns, split)
    res["resume_karel"] = timed("data karel resume", streamed_resume,
                                "karel", split, split)
    res["vizdoom"] = timed("data vizdoom streamed", streamed_train, vz_train,
                           "vizdoom_streaming", DATA_VZD_STEPS,
                           DATA_VZD_LOG_STEP, "vizdoom", VZD_K, vz_test,
                           VZD_EVAL_BATCHES)
    res["turns_vizdoom"] = timed("data vizdoom turns", loop_turns, vz_train,
                                 vz_test, "vizdoom", VZD_K, DATA_VZD_STEPS,
                                 DATA_VZD_LOG_STEP)
    res["resume_vizdoom"] = timed("data vizdoom resume", streamed_resume,
                                  "vizdoom", vz_train, vz_test, "vizdoom",
                                  VZD_K)
    res["profiled"] = timed("data profiled", profiled_run, split)
    return res


# the data-parallel phase: NCCL at world 1 over TRAIN_STEPS Karel steps
# (checkpoint bitwise equal to train_phase's), then gloo at world DP_WORLD
# with both ranks on the card: DP_STEPS Karel and ViZDoom steps logged every
# step, the Karel run again stopped at DP_STEPS // 2 and resumed, and
# DP_TIMING_STEPS timed steps. Every step's loss within LOSS_ATOL and grad
# norm within NORM_RTOL of the single process's step on the same global
# batch from the same parameters; an independent single-process run over
# the same batches drifts away from step 2 on (Adam turns rounding into
# steps: 4e-4 in loss by step 8 on the H100), so its distance is a reading.
DP_STEPS, DP_TIMING_STEPS = 10, 3
DP_DEVICE = "cuda:0"  # of every rank (gloo takes two ranks on one card)
DP_BACKENDS = ("nccl", "gloo")  # of the world-1 run and the world-2 runs
# bf16 on the meshes: DP_BF16_STEPS steps a run, each within BF16_TOL of the
# single process's bf16 step from the same parameters
DP_BF16_STEPS = 4
# the 2-D Doom cache's demos at dp 2 x demo 2: 25 do not split over 2
SOURCE_VZD_K = 20


def bf16_run(domain, **kw):
    """A run of DP_BF16_STEPS bf16 steps of `domain` on a mesh, logged every
    step."""
    return dict(name=f"{domain}_bf16", dir=f"{domain}_bf16",
                dataset_type=domain, steps=DP_BF16_STEPS, log_step=1,
                flags=BF16_FLAGS, **kw)


def _dp_rank(rank, world, backend, job_path, out_dir):
    """One rank of dp_phase: the entry points' process-wide modes, a
    process group over a file store, the job's runs -> rank<r>.pt."""
    deterministic_cuda()
    full_precision_matmuls()
    job = torch.load(job_path, weights_only=False)
    make_mesh(backend=backend, device=job["device"], rank=rank,
              world_size=world, init_method=f"file://{job['store']}")
    try:
        out = {run["name"]: dp_run(job, run) for run in job["runs"]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def replicas_equal(model, mesh):
    """Are the parameters and BN statistics of every rank of the mesh's
    world equal bit for bit? (Their bits, summed into a zero row per rank
    across the world.)"""
    tensors = list(model.parameters()) + [
        b for b in model.buffers() if b.dtype == torch.float32]
    bits = torch.cat([t.detach().reshape(-1) for t in tensors]).view(
        torch.int32)
    rows = gather_rows(bits[None], mesh)
    return bool((rows == rows[0]).all())


def dp_run(job, run):
    """A Trainer of run["args"] on this rank (on job["device"], the
    group's mesh) -> its launches, whether the replicas stayed equal after
    every step, the global rows of each ViZDoom step, and with run["timed"]
    the step's phase times."""
    args = run["args"]
    split = job[args.dataset_type]
    trainer = Trainer(args, split, split, device=job["device"])
    if run.get("target"):  # the killed run's stage target
        if trainer.writes:
            with open(os.path.join(run["train_dir"], "resume.json"),
                      "w") as f:
                json.dump({"target_step": run["target"]}, f)
        trainer.mesh.barrier()
    out = {"world": trainer.mesh.world, "rank": trainer.mesh.rank,
           "backend": trainer.mesh.backend, "replicas_equal": [],
           "steps": []}
    if args.dataset_type == "vizdoom":
        out["global_rows"] = [np.concatenate(trainer.cache.draws(s)[1])
                              for s in range(args.max_steps)]
    reference = (single_step_reference(trainer, split, out.get("global_rows"))
                 if run.get("reference") and trainer.writes else None)
    step = trainer.train_step

    def checked(batch):
        if reference is not None:  # from the parameters before the step
            single = reference(trainer.state.step)
        report = step(batch)
        if reference is not None:
            out["steps"].append({"loss": report["loss"].item(),
                                 "grad_norm": report["grad_norm"].item(),
                                 "single": single})
        if trainer.mesh.world > 1:
            out["replicas_equal"].append(replicas_equal(trainer.model,
                                                        trainer.mesh))
        return report

    trainer.train_step = checked
    fused_lstm.reset_launches()
    trainer.train(max_steps=run.get("max_steps", args.max_steps))
    synchronize(trainer.device)
    out["launches"] = fused_lstm.fused_lstm_step.launches
    out["launches_by_dtype"] = {
        str(d): n for d, n in
        fused_lstm.fused_lstm_step.launches_by_dtype.items()}
    out["per_step"], out["per_sample"] = lstm_launches(trainer.cfg)
    if run.get("timed"):
        out["step_s"] = mesh_step_times(
            trainer.state, trainer.cfg, trainer.cache.batch(0), trainer.mesh,
            job["timing_steps"])
        if trainer.writes:  # the global batch's step in one process
            cache = trainer.cache
            batch = {k: v.index_select(0, cache.indices(0))
                     for k, v in cache.data.items()}
            out["single_step_s"] = single_step_times(
                trainer.cfg, trainer.model, batch, job["timing_steps"],
                trainer.args.learning_rate)
        trainer.mesh.barrier()
    return out


def single_step_reference(trainer, split, global_rows=None):
    """-> reference(s): (loss, grad norm) of one single-process train step
    (no process group, no update) from a copy of the trainer's parameters
    on the global batch of step s: the Karel cache's global draw, or the
    ViZDoom rows `global_rows[s]` of an unsharded cache of `split`."""
    cfg, device = trainer.cfg, trainer.device
    model = get_model_class(cfg.model)(cfg).to(device)
    if global_rows is None:
        cache = trainer.cache
        rows = cache.indices
    else:
        cache = DoomDeviceCache(split, device, trainer.args.batch_size,
                                trainer.args.seed)
        rows = lambda s: torch.as_tensor(global_rows[s], device=device)

    def reference(s):
        batch = {k: v.index_select(0, rows(s)) for k, v in cache.data.items()}
        return uncounted(single_loss_norm, model, trainer.model, cfg, batch)

    return reference


def uncounted(fn, *args):
    """fn(*args) with the kernel's launch counts left as they were:
    launches made for a comparison or a timing do not count."""
    counts = (fused_lstm.fused_lstm_step.launches,
              dict(fused_lstm.fused_lstm_step.launches_by_dtype))
    try:
        return fn(*args)
    finally:
        fused_lstm.fused_lstm_step.launches = counts[0]
        fused_lstm.fused_lstm_step.launches_by_dtype.clear()
        fused_lstm.fused_lstm_step.launches_by_dtype.update(counts[1])


def single_loss_norm(ref, model, cfg, batch):
    """(loss, grad norm) of one single-process train step (no process
    group, no update) of `ref`, a model of cfg, from `model`'s parameters
    on the global `batch`."""
    ref.load_state_dict(model.state_dict())
    loss, _ = forward_loss(ref, cfg, batch, cfg.model)
    loss.backward()
    norm = global_norm([p.grad for p in ref.parameters()
                        if p.grad is not None])
    ref.zero_grad(set_to_none=True)
    return {"loss": loss.item(), "grad_norm": norm.item()}


def single_step_times(cfg, model, batch, steps, learning_rate):
    """Median seconds of the single-process step (no process group) of a
    copy of `model` on the global `batch`: forward and backward, the
    optimizer and the whole (after one warm-up step), each ended by a
    synchronise; the same card and the same call as the mesh's step."""
    ref = copy.deepcopy(model)
    state = TrainState(ref, learning_rate)
    device = next(ref.parameters()).device

    def now():
        synchronize(device)
        return time.perf_counter()

    runs = []
    for _ in range(steps + 1):
        t0 = now()
        loss, _ = forward_loss(ref, cfg, batch, cfg.model)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        t1 = now()
        state.apply_gradients()
        t2 = now()
        runs.append({"compute": t1 - t0, "optimizer": t2 - t1,
                     "total": t2 - t0})
    return {k: float(np.median([r[k] for r in runs[1:]])) for k in runs[0]}


def dp_args(out_dir, run, dataset_type="karel"):
    """trainer_args of a dp_phase run: run["steps"] a stage, a checkpoint
    at its end, a log line every run["log_step"] steps, run["num_k"] demos
    (default the domain's), run["flags"] added."""
    num_k = run.get("num_k") or (VZD_K if dataset_type == "vizdoom"
                                  else None)
    return trainer_args(os.path.join(out_dir, run["dir"]), run["steps"],
                        run["log_step"], dataset_type=dataset_type,
                        num_k=num_k, extra_flags=run.get("flags", ()))


def spawn_ranks(world, backend, job, tag, device=None, rank_main=None):
    """Run `job` (its runs' trainer args made here) on `world` spawned
    ranks, each on `device` (default DP_DEVICE; "cuda": a card a rank),
    each running `rank_main` (default _dp_rank) -> each rank's results,
    the job."""
    out_dir = os.path.join(OUT_DIR, tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    job = dict(job, store=os.path.join(out_dir, "store"),
               device=device or DP_DEVICE, timing_steps=DP_TIMING_STEPS)
    for run in job["runs"]:
        run["args"] = dp_args(out_dir, run, run.get("dataset_type", "karel"))
        run["train_dir"] = run["args"].train_dir
    job_path = os.path.join(out_dir, "job.pt")
    torch.save(job, job_path)
    mp.start_processes(rank_main or _dp_rank,
                       args=(world, backend, job_path, out_dir),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)], job


def train_rows(train_dir):
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f)
                if r["split"] == "train"}


def single_reference(split, dataset_type, train_dir, rows=None):
    """The single-process run of dp_phase's gloo runs (no process group),
    logging every step; with `rows`, each step's global rows of the ViZDoom
    cache are the dp run's -> its metrics rows by step."""
    shutil.rmtree(train_dir, ignore_errors=True)
    num_k = VZD_K if dataset_type == "vizdoom" else None
    trainer = Trainer(trainer_args(train_dir, DP_STEPS, 1,
                                   dataset_type=dataset_type, num_k=num_k),
                      split, split, device=DP_DEVICE)
    check(trainer.mesh.group is None, "the reference run formed a group")
    if rows is not None:
        trainer.cache.indices = lambda s: rows[s]
    trainer.train(max_steps=DP_STEPS)
    synchronize(trainer.device)
    return train_rows(train_dir)


def dp_against_single(tag, dp, dp_dir, single=None, tol=F32_TOL,
                      n_steps=DP_STEPS):
    """The dp run (rank 0's `dp` results and metrics, global values)
    against the single process: each of its `n_steps` steps' loss
    (tol["loss_atol"]) and grad norm (tol["norm_rtol"]) against the single
    process's step (in the run's compute dtype) from the same parameters
    on the same global batch, gated; against the independent single-process
    run `single` (its metrics rows), a reading."""
    steps = dp["steps"]
    loss = [abs(x["loss"] - x["single"]["loss"]) for x in steps]
    norm = [abs(x["grad_norm"] - x["single"]["grad_norm"])
            / x["single"]["grad_norm"] for x in steps]
    check(len(steps) == n_steps, f"{tag}: {len(steps)} steps compared")
    res = {"step_loss_abs_diff": loss, "step_grad_norm_rel_diff": norm,
           "loss": [x["loss"] for x in steps]}
    if single is not None:
        rows = train_rows(dp_dir)
        check(sorted(rows) == sorted(single) == list(range(1, DP_STEPS + 1)),
              f"{tag}: logged steps {sorted(rows)} and {sorted(single)}")
        res["run_loss_abs_diff"] = [abs(rows[s]["loss"] - single[s]["loss"])
                                    for s in sorted(rows)]
        res["run_grad_norm_rel_diff"] = [
            abs(rows[s]["grad_norm"] - single[s]["grad_norm"])
            / single[s]["grad_norm"] for s in sorted(rows)]
    print(f"dp {tag} vs single process " + json.dumps(res), flush=True)
    check(max(loss) <= tol["loss_atol"], f"{tag}: a step's loss differs "
          f"from the single process's step by {max(loss)}")
    check(max(norm) <= tol["norm_rtol"], f"{tag}: a step's grad norm "
          f"differs from the single process's step by {max(norm)} of it")
    return res


def check_dp_ranks(ranks, steps, world, backend):
    """Every rank of every run of `steps` ({run name: steps taken}): the
    mesh, the replicas bitwise equal after each step, and its launches
    (a test sample at step 0, none in a resumed run) -> launches per rank
    of each run."""
    launches = {}
    for name, n in steps.items():
        for r in ranks:
            got = r[name]
            check(got["world"] == world and got["backend"] == backend,
                  f"dp {name}: mesh {got['world']} {got['backend']}")
            check(len(got["replicas_equal"]) == n
                  and all(got["replicas_equal"]),
                  f"dp {name}: the replicas differ after a step "
                  f"{got['replicas_equal']}")
            samples = int(not name.endswith("_resumed"))
            want = n * got["per_step"] + samples * got["per_sample"]
            check(got["launches"] == want, f"dp {name} rank {got['rank']}: "
                  f"{got['launches']} launches, expected {n} x "
                  f"{got['per_step']} + {samples} x {got['per_sample']}")
        launches[name] = [r[name]["launches"] for r in ranks]
    return launches


def dp_phase(split, vizdoom_splits, train_ckpt):
    """Data parallelism on the card (parallel/mesh.py) through the Trainer,
    each rank a spawned process: NCCL at world 1 (a checkpoint bitwise equal
    to the single-process trainer's `train_ckpt`), then gloo at world
    DP_WORLD with both ranks on cuda:0 (NCCL takes one card a rank): Karel
    and ViZDoom (the sharded device cache) runs held step by step against a
    single-process run over the same global batches, the replicas bitwise
    equal after every step, exact launches per rank, a resumed run bitwise
    equal to the uninterrupted one, and the step's time split into compute
    and the gradients' all-reduce."""
    vz_train = vizdoom_splits[0]
    karel = {"dataset_type": "karel"}
    ranks, job = spawn_ranks(1, DP_BACKENDS[0], {"karel": split, "runs": [dict(
        karel, name="nccl", dir="nccl", steps=TRAIN_STEPS,
        log_step=TRAIN_LOG_STEP)]}, "dp_nccl")
    nccl = ranks[0]["nccl"]
    check(nccl["backend"] == DP_BACKENDS[0] and nccl["world"] == 1,
          f"the NCCL run's mesh: {nccl}")
    nccl_ckpt = checkpoint.checkpoint_path(job["runs"][0]["train_dir"],
                                           TRAIN_STEPS)
    nccl_equal = equal_states(checkpoint.load(nccl_ckpt),
                              checkpoint.load(train_ckpt))
    expected = TRAIN_STEPS * nccl["per_step"] + nccl["per_sample"]
    check(nccl["launches"] == expected, f"NCCL world 1: {nccl['launches']} "
          f"launches, expected {expected}")
    check(nccl_equal, "NCCL world 1: the checkpoint differs from the "
          "single-process trainer's")

    half = DP_STEPS // 2
    runs = [dict(karel, name="karel", dir="karel", steps=DP_STEPS,
                 log_step=1, timed=True, reference=True),
            dict(karel, name="karel_half", dir="karel_c", steps=DP_STEPS,
                 log_step=1, max_steps=half),
            dict(karel, name="karel_resumed", dir="karel_c", steps=DP_STEPS,
                 log_step=1, target=DP_STEPS),
            dict(name="vizdoom", dir="vizdoom", dataset_type="vizdoom",
                 steps=DP_STEPS, log_step=1, reference=True)]
    t0 = time.perf_counter()
    ranks, job = spawn_ranks(DP_WORLD, DP_BACKENDS[1], {
        "karel": split, "vizdoom": vz_train, "runs": runs}, "dp_gloo")
    gloo_s = time.perf_counter() - t0
    dirs = {run["name"]: run["train_dir"] for run in job["runs"]}
    res = {"card": CARD, "world": DP_WORLD, "backend": DP_BACKENDS[1],
           "nccl_world1_bitwise_equal": nccl_equal,
           "nccl_world1_launches": nccl["launches"], "gloo_seconds": gloo_s}
    launches = check_dp_ranks(ranks, {"karel": DP_STEPS, "vizdoom": DP_STEPS,
                                      "karel_half": half,
                                      "karel_resumed": DP_STEPS - half},
                              DP_WORLD, DP_BACKENDS[1])
    res.update({f"{n}_launches_per_rank": v for n, v in launches.items()})
    res["per_step_launches"] = {n: ranks[0][n]["per_step"]
                                for n in ("karel", "vizdoom")}
    a, c = (checkpoint.load(checkpoint.checkpoint_path(dirs[n], DP_STEPS))
            for n in ("karel", "karel_resumed"))
    res["resumed_bitwise_equal"] = equal_states(a, c)
    check(res["resumed_bitwise_equal"], "dp: the world-2 run resumed at step "
          f"{half} differs from the uninterrupted one")
    res["karel"] = dp_against_single(
        "karel", ranks[0]["karel"], dirs["karel"], single_reference(
            split, "karel", os.path.join(OUT_DIR, "dp_single_karel")))
    res["vizdoom"] = dp_against_single(
        "vizdoom", ranks[0]["vizdoom"], dirs["vizdoom"], single_reference(
            vz_train, "vizdoom", os.path.join(OUT_DIR, "dp_single_vizdoom"),
            rows=ranks[0]["vizdoom"]["global_rows"]))
    res["step_s"] = [r["karel"]["step_s"] for r in ranks]
    res["single_step_s"] = ranks[0]["karel"]["single_step_s"]
    print(f"dp step ({CARD}): world {DP_WORLD}, gloo, both ranks on "
          f"cuda:0, Karel bs {BATCH} (rows a rank {BATCH // DP_WORLD}), "
          f"median s of rank 0: " + json.dumps(res["step_s"][0])
          + "; the single process's step on the same card: "
          + json.dumps(res["single_step_s"]), flush=True)
    print("dp " + json.dumps(res), flush=True)
    return res


def dp_bf16_phase(split, vz_train):
    """bf16 compute on the 1-D mesh (--compute_dtype bfloat16 through the
    Trainer, as dp_phase's gloo runs): world DP_WORLD, both ranks on
    cuda:0, DP_BF16_STEPS Karel and ViZDoom steps; each step's loss and
    grad norm within BF16_TOL of the single process's bf16 step from the
    same parameters on the same global batch, the replicas bitwise equal
    after every step, 125 / 60 launches a rank a step and a test sample's
    190 / 99, every one on the kernel's bf16 entry."""
    runs = [bf16_run(d, reference=True) for d in ("karel", "vizdoom")]
    ranks, _ = spawn_ranks(DP_WORLD, DP_BACKENDS[1], {
        "karel": split, "vizdoom": vz_train, "runs": runs}, "dp_bf16")
    res = {"card": CARD, "world": DP_WORLD, "backend": DP_BACKENDS[1],
           "launches_per_rank": check_dp_ranks(
               ranks, {run["name"]: DP_BF16_STEPS for run in runs},
               DP_WORLD, DP_BACKENDS[1])}
    for run in runs:
        name = run["name"]
        for r in ranks:
            got = r[name]
            on_entry = got["launches_by_dtype"].get(str(torch.bfloat16), 0)
            check(on_entry == got["launches"], f"dp bf16 {name}: "
                  f"{on_entry} of {got['launches']} launches on the bf16 "
                  f"entry")
        res[name] = dp_against_single(f"bf16 {name}", ranks[0][name], None,
                                      tol=BF16_TOL, n_steps=DP_BF16_STEPS)
    print("dp bf16 " + json.dumps(res), flush=True)
    return res


def dp_cards_phase(split, vz_train):
    """Data parallelism over every card of the machine, one NCCL rank a
    card (cuda:<rank>), when it has more than one: DP_STEPS Karel and
    ViZDoom steps, each held against the single process's step from the
    same parameters on the same global batch, the replicas bitwise equal
    after every step, exact launches per rank, and the step's time split
    into compute and the gradients' all-reduce beside the single process's
    step on the same global batch in the same call; with four cards or
    more, also Karel on the 2-D mesh at dp 2 x demo 2, a card a rank
    (demo_spawn)."""
    world = torch.cuda.device_count()
    runs = [dict(name="karel", dir="karel", dataset_type="karel",
                 steps=DP_STEPS, log_step=1, timed=True, reference=True),
            dict(name="vizdoom", dir="vizdoom", dataset_type="vizdoom",
                 steps=DP_STEPS, log_step=1, reference=True)]
    ranks, job = spawn_ranks(world, "nccl", {
        "karel": split, "vizdoom": vz_train, "runs": runs}, "dp_cards",
        device="cuda")
    dirs = {run["name"]: run["train_dir"] for run in job["runs"]}
    res = {"card": CARD, "world": world, "backend": "nccl",
           "launches_per_rank": check_dp_ranks(
               ranks, {"karel": DP_STEPS, "vizdoom": DP_STEPS}, world,
               "nccl")}
    for name in ("karel", "vizdoom"):
        res[name] = dp_against_single(f"{name} over {world} cards",
                                      ranks[0][name], dirs[name])
    res["step_s"] = [r["karel"]["step_s"] for r in ranks]
    res["single_step_s"] = ranks[0]["karel"]["single_step_s"]
    print(f"dp cards step ({CARD}): world {world}, nccl, a card a rank, "
          f"Karel bs {BATCH} (rows a rank {BATCH // world}), median s of "
          f"rank 0: " + json.dumps(res["step_s"][0]) + "; the single "
          f"process's step on cuda:0 in this call: "
          + json.dumps(res["single_step_s"]), flush=True)
    if world >= 4:  # the 2-D mesh, a card a rank
        res["demo_mesh"] = demo_spawn("karel", split, "nccl", device="cuda",
                                      tag="dp_cards_demo_karel")[0]
    print("dp cards " + json.dumps(res), flush=True)
    return res


def _demo_rank(rank, world, backend, job_path, out_dir):
    """One rank of dp_demo_phase: the entry points' process-wide modes, the
    job's 2-D mesh over a file store, the job's runs -> rank<r>.pt."""
    deterministic_cuda()
    full_precision_matmuls()
    job = torch.load(job_path, weights_only=False)
    dp, demo_par = job["mesh"]
    mesh = make_mesh_2d(dp, demo_par, backend=backend, device=job["device"],
                        rank=rank, world_size=world,
                        init_method=f"file://{job['store']}")
    try:
        out = {run["name"]: DEMO_RUNS[run.get("kind", "train")](job, run,
                                                               mesh)
               for run in job["runs"]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def demo_run(job, run, mesh):
    """run["steps"] steps of the port's train step (make_train_step over
    the 2-D `mesh`, in the compute dtype of run["flags"]) of a full model at
    full width drawn from SEED, each on the rank's part (shard_batch_2d) of
    the step's global batch: the draw of an unsharded device cache, compact
    with run["compact"] (the replay runs on the rank's demos), else
    expanded -> the mesh, the launches (by dtype), the replicas' equality
    after every step, on rank 0 each step against the single process's
    step from the same parameters on the same global batch (the launches
    of that comparison do not count), and with run["timed"] the step's
    phase times beside the single process's."""
    args = run["args"]
    split = job[args.dataset_type]
    cfg = config_from_dataset(args, split)
    device = mesh.device
    model = get_model_class(cfg.model)(cfg)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model.to(device)
    state = TrainState(model, args.learning_rate)
    step = make_train_step(state, cfg, cfg.model, mesh=mesh)
    cache = (KarelDeviceCache if args.dataset_type == "karel"
             else DoomDeviceCache)(split, device, args.batch_size, args.seed)
    ref = (get_model_class(cfg.model)(cfg).to(device) if mesh.rank == 0
           else None)
    out = {"mesh": (mesh.world, mesh.dp, mesh.demo_par, mesh.backend),
           "rank": mesh.rank, "replicas_equal": [], "steps": []}

    def global_batch(s):
        batch = cache.batch(s)
        return batch if run.get("compact") else expand_batch(batch, cfg)

    fused_lstm.reset_launches()
    for s in range(run["steps"]):
        batch = global_batch(s)
        local = {k: v.contiguous()
                 for k, v in shard_batch_2d(batch, mesh).items()}
        single = (uncounted(single_loss_norm, ref, model, cfg, batch)
                  if ref is not None else None)
        report = step(local)
        if ref is not None:
            out["steps"].append({"loss": report["loss"].item(),
                                 "grad_norm": report["grad_norm"].item(),
                                 "single": single})
        out["replicas_equal"].append(replicas_equal(model, mesh))
    synchronize(device)
    out["launches"] = fused_lstm.fused_lstm_step.launches
    out["on_entry"] = fused_lstm.fused_lstm_step.launches_by_dtype[
        COMPUTE_DTYPES[cfg.compute_dtype]]
    out["compute_dtype"], out["n_steps"] = cfg.compute_dtype, run["steps"]
    out["per_step"], _ = lstm_launches(cfg)
    out["local_k"] = local["demo_len"].shape[1]
    if run.get("timed"):
        out["step_s"] = mesh_step_times(state, cfg, local, mesh,
                                        job["timing_steps"])
        if ref is not None:
            out["single_step_s"] = single_step_times(
                cfg, model, batch, job["timing_steps"], args.learning_rate)
        mesh.barrier()
    return out


# the 2-D eval: the decode modes of the train phase's checkpoint on one
# global batch, and which evals of each are token ids
EVAL_2D_MODES = ("greedy", "beam", "syntax_greedy", "syntax_sample")
EVAL_2D_TOKENS = {"greedy": ("greedy_tokens", "greedy_len"),
                  "beam": ("beam_tokens", "beam_lengths"),
                  "syntax_greedy": ("greedy_tokens", "greedy_len"),
                  "syntax_sample": ("greedy_tokens", "greedy_len")}
EVAL_2D_ATOL = 1e-4  # the report, 2-D against one process, f32


def eval_2d_run(job, run, mesh):
    """The port's eval step (make_eval_step over the 2-D `mesh`) of the
    full model at job["checkpoint"] on the rank's part of one global Karel
    batch, in each of EVAL_2D_MODES (beam: K = BEAM_WIDTH, then the
    execution rerank on the global batch) -> per mode its launches, report
    and token ids gathered over the data index; on rank 0 also the single
    process's eval step on the global batch (launches uncounted), the
    smallest gap of each row's choices there (ChoiceGaps) and both reranks'
    picks."""
    split = job["karel"]
    cfg = dataclasses.replace(config_from_dataset(run["args"], split),
                              beam_width=BEAM_WIDTH)
    device = mesh.device
    model = get_model_class("full")(cfg)
    model.load_state_dict(checkpoint.load(job["checkpoint"])["model"])
    model.to(device)
    raw = split.get_batch_compact(split.ids[:BATCH])
    batch = to_device(raw, device)
    local = {k: v.contiguous() for k, v in shard_batch_2d(batch, mesh).items()}
    scorer = KarelScorer(cfg, device)
    rows = data_axis(mesh)
    out = {"mesh": (mesh.world, mesh.dp, mesh.demo_par, mesh.backend),
           "rank": mesh.rank, "per_batch": lstm_launches(cfg)[1]}

    def picks(evals):
        order = np.argsort(-evals["beam_scores"], axis=1, kind="stable")
        bt = np.take_along_axis(evals["beam_tokens"], order[:, :, None], 1)
        bl = np.take_along_axis(evals["beam_lengths"].astype(np.int32),
                                order, axis=1)
        return scorer.rerank_pick(bt, bl, batch)

    def host(report, evals):
        return ({k: float(v) for k, v in report.items()},
                {k: v.cpu().numpy() for k, v in evals.items() if v.dim()})

    for mode in EVAL_2D_MODES:
        fused_lstm.reset_launches()
        report, evals = make_eval_step(model, cfg, "full", decode_mode=mode,
                                       mesh=mesh)(local)
        evals = {k: gather_rows(v, rows) for k, v in evals.items()
                 if v.dim()}
        synchronize(device)
        res = {"launches": fused_lstm.fused_lstm_step.launches}
        res["report"], evals = host(report, evals)
        res["tokens"] = {k: evals[k] for k in EVAL_2D_TOKENS[mode]}
        if mesh.rank == 0:
            gaps = ChoiceGaps(BATCH)
            with gaps.patched():
                single = uncounted(make_eval_step(model, cfg, "full",
                                                  decode_mode=mode), batch)
            res["single_report"], single = host(*single)
            res["single_tokens"] = {k: single[k]
                                    for k in EVAL_2D_TOKENS[mode]}
            res["gaps"] = gaps.gaps.cpu().numpy()
            if mode == "beam":
                res["picks"], res["single_picks"] = picks(evals), picks(
                    single)
        out[mode] = res
    return out


def check_eval_2d(ranks):
    """The 2-D eval of every mode: each rank's launches one batch's 190
    (5 T + 2 L at the rank's rows), the ranks' reports and token ids equal;
    rank 0's report within EVAL_2D_ATOL of the single process's, and on the
    rows whose every choice there lies TIE_GAP clear of a tie (at least a
    quarter of the batch) the token ids and the rerank's picks equal ->
    per mode the launches per rank and the distances."""
    res = {}
    for mode in EVAL_2D_MODES:
        for r in ranks:
            got = r[mode]
            check(got["launches"] == r["per_batch"],
                  f"eval 2-D {mode} rank {r['rank']}: {got['launches']} "
                  f"launches, expected {r['per_batch']}")
            check(got["report"] == ranks[0][mode]["report"] and all(
                np.array_equal(v, ranks[0][mode]["tokens"][k])
                for k, v in got["tokens"].items()),
                  f"eval 2-D {mode}: rank {r['rank']} differs from rank 0")
        first = ranks[0][mode]
        report_err = max(abs(v - first["single_report"][k])
                         for k, v in first["report"].items())
        clear = first["gaps"] >= TIE_GAP
        n_rows = int(clear.sum())
        mismatch = sum(int((~np.equal(v, first["single_tokens"][k]).reshape(
            BATCH, -1).all(axis=1) & clear).sum())
            for k, v in first["tokens"].items())
        res[mode] = {"launches_per_rank": [r[mode]["launches"]
                                           for r in ranks],
                     "report_max_abs_diff": report_err,
                     "rows_compared": n_rows, "token_mismatch_rows": mismatch}
        if mode == "beam":
            res[mode]["pick_mismatch_rows"] = int(
                ((first["picks"] != first["single_picks"]) & clear).sum())
            mismatch += res[mode]["pick_mismatch_rows"]
        check(set(first["report"]) == set(first["single_report"])
              and report_err <= EVAL_2D_ATOL, f"eval 2-D {mode}: the report "
              f"differs from the single process's by {report_err}")
        check(n_rows >= BATCH // 4, f"eval 2-D {mode}: only {n_rows} of "
              f"{BATCH} rows have every choice {TIE_GAP} clear of a tie")
        check(mismatch == 0, f"eval 2-D {mode}: {mismatch} rows clear of "
              f"ties decode otherwise than in one process")
    print("eval 2-D " + json.dumps(res), flush=True)
    return res


def sources_2d_run(job, run, mesh):
    """One train step from each 2-D batch source at step 0 (KarelDeviceCache
    and BatchPipeline on the Karel split, DoomDeviceCache on the ViZDoom
    split at SOURCE_VZD_K demos), each against the 2-D step from the same
    parameters on shard_batch_2d of the same global batch (an unsharded
    source's; for the Doom cache its global rows gathered from an
    unsharded cache) -> per source whether the batches, the reports and the
    parameters after the step are equal bit for bit."""
    device, seed = mesh.device, run["args"].seed
    out = {"rank": mesh.rank}
    for name, dataset in (("karel_cache", job["karel"]),
                          ("pipeline", job["karel"]),
                          ("doom_cache", job["vizdoom"])):
        doom = name == "doom_cache"
        args = trainer_args(run["args"].train_dir, 1, 1,
                            dataset_type="vizdoom" if doom else "karel",
                            num_k=SOURCE_VZD_K if doom else None)
        cfg = config_from_dataset(args, dataset)
        if name == "karel_cache":
            got = KarelDeviceCache(dataset, device, BATCH, seed,
                                   mesh=mesh).batch(0)
            want = KarelDeviceCache(dataset, device, BATCH, seed).batch(0)
        elif name == "pipeline":
            pipes = [BatchPipeline(dataset, BATCH, device, seed=seed,
                                   compact=True, mesh=m) for m in (mesh, None)]
            got, want = (next(p) for p in pipes)
            for p in pipes:
                p.close()
            got, want = ({k: v for k, v in b.items() if k != "id"}
                         for b in (got, want))
        else:
            cache = DoomDeviceCache(dataset, device, BATCH, seed, mesh=mesh)
            got = cache.batch(0)
            whole = DoomDeviceCache(dataset, device, BATCH, seed)
            rows = torch.as_tensor(np.concatenate(cache.draws(0)[1]),
                                   device=device)
            want = {k: v.index_select(0, rows) for k, v in whole.data.items()}
            del whole
        want = {k: v.contiguous()
                for k, v in shard_batch_2d(want, mesh).items()}
        same_batch = set(got) == set(want) and all(
            torch.equal(got[k], want[k]) for k in want)
        states = []
        for batch in (got, want):
            model = get_model_class("full")(cfg)
            init_parameters(model, torch.Generator().manual_seed(SEED))
            model.to(device)
            state = TrainState(model, args.learning_rate)
            report = make_train_step(state, cfg, "full", mesh=mesh)(batch)
            states.append(({k: v.item() for k, v in report.items()},
                           model.state_dict()))
        synchronize(device)
        (r_got, sd_got), (r_want, sd_want) = states
        out[name] = {"batch_equal": same_batch, "report_equal":
                     r_got == r_want, "params_equal": all(
                         torch.equal(v, sd_want[k])
                         for k, v in sd_got.items()),
                     "local_k": int(got["demo_len"].shape[1]),
                     "rows": int(got["demo_len"].shape[0])}
    return out


def check_sources_2d(ranks):
    """Every rank's batch of each 2-D source equals shard_batch_2d of its
    global batch bit for bit, and so do the report and the parameters
    after one step on it."""
    for r in ranks:
        for name in ("karel_cache", "pipeline", "doom_cache"):
            got = r[name]
            check(got["batch_equal"] and got["report_equal"]
                  and got["params_equal"], f"source 2-D {name} rank "
                  f"{r['rank']}: {got}")
    res = {name: {k: ranks[0][name][k] for k in ("local_k", "rows")}
           for name in ("karel_cache", "pipeline", "doom_cache")}
    print("sources 2-D " + json.dumps(res), flush=True)
    return res


DEMO_RUNS = {"train": demo_run, "eval": eval_2d_run,
             "sources": sources_2d_run}


def mesh_step_times(state, cfg, batch, mesh, steps):
    """Median seconds of a data-parallel step's phases on the rank's
    `batch`, each ended by a synchronise, with every all-reduce inside
    forward and backward timed between two synchronisations and summed by
    group: `world` (BatchNorm's sums, the objective's denominators), and on
    a 2-D mesh `demo` (the demo group's sums and gathers over the k demos)
    and `data` (the per-demo denominators); `compute` is forward and
    backward without them; then the gradients' all-reduce and the
    optimizer (after one warm-up step)."""
    device = mesh.device
    names = {id(g): n for n, g in (("demo", mesh.demo_group),
                                    ("data", mesh.data_group))
             if g is not None}
    real = dist.all_reduce
    spent = {}

    def all_reduce(t, *a, group=None, **kw):
        synchronize(device)
        t0 = time.perf_counter()
        work = real(t, *a, group=group, **kw)
        synchronize(device)
        key = names.get(id(group), "world")
        spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
        return work

    def now():
        synchronize(device)
        return time.perf_counter()

    runs = []
    for _ in range(steps + 1):
        spent.clear()
        t0 = now()
        with mock.patch.object(dist, "all_reduce", all_reduce):
            loss, _ = forward_loss(state.model, cfg, batch, cfg.model, mesh)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        t1 = now()
        all_reduce_gradients(state.params, mesh)
        t2 = now()
        state.apply_gradients()
        t3 = now()
        inside = {f"{k}_collectives": spent.get(k, 0.0)
                  for k in ("demo", "data", "world")}
        runs.append(dict(inside, compute=t1 - t0 - sum(inside.values()),
                         all_reduce=t2 - t1, optimizer=t3 - t2,
                         total=t3 - t0))
    return {k: float(np.median([r[k] for r in runs[1:]])) for k in runs[0]}


def check_demo_ranks(tag, ranks, world, dp, demo_par, backend, names):
    """Every rank of the train runs `names` of a dp_demo_phase spawn: the
    mesh, the replicas bitwise equal after each step, steps x (4 T + L)
    launches, every one on the entry of the run's compute dtype, and its
    k / D demos; rank 0's steps against the single process's
    (dp_against_single's gate at the dtype's STEP_TOL) -> {run: launches
    per rank, the comparison, the step's times}."""
    res = {}
    for name in names:
        for r in ranks:
            got = r[name]
            n = got["n_steps"]
            check(got["mesh"] == (world, dp, demo_par, backend),
                  f"{tag} {name}: mesh {got['mesh']}")
            check(len(got["replicas_equal"]) == n
                  and all(got["replicas_equal"]),
                  f"{tag} {name}: the replicas differ after a step "
                  f"{got['replicas_equal']}")
            want = n * got["per_step"]
            check(got["launches"] == want == got["on_entry"],
                  f"{tag} {name} rank {got['rank']}: {got['launches']} "
                  f"launches ({got['on_entry']} on the "
                  f"{got['compute_dtype']} entry), expected {n} x "
                  f"{got['per_step']}")
        first = ranks[0][name]
        res[name] = {
            "launches_per_rank": [r[name]["launches"] for r in ranks],
            "per_step": first["per_step"], "local_k": first["local_k"],
            "compute_dtype": first["compute_dtype"],
            "vs_single": dp_against_single(
                f"{tag} {name}", first, None,
                tol=STEP_TOL[first["compute_dtype"]],
                n_steps=first["n_steps"])}
        if "step_s" in first:
            res[name]["step_s"] = first["step_s"]
            res[name]["single_step_s"] = first["single_step_s"]
            print(f"dp demo step ({CARD}): {tag} {name}, world {world} = "
                  f"dp {dp} x demo {demo_par}, {backend}, {first['local_k']} "
                  f"demos and {BATCH // dp} rows a rank, median s of rank 0: "
                  + json.dumps(first["step_s"]) + "; the single process's "
                  "step on the same card: "
                  + json.dumps(first["single_step_s"]), flush=True)
    return res


def demo_spawn(domain, data, backend, device=None, tag=None, extra=(),
               job=None):
    """dp_demo_phase's runs of `domain` on its DEMO_MESHES mesh: Karel on
    expanded and on compact batches, ViZDoom on expanded ones, the first
    timed, then the `extra` runs (`job`'s entries added to the job) ->
    (check_demo_ranks' results of the train runs, {run: each rank's
    results} of every other run)."""
    dp, demo_par = DEMO_MESHES[domain]
    runs = [dict(name=domain, dir=domain, dataset_type=domain,
                 steps=DP_STEPS, log_step=1, timed=True)]
    if domain == "karel":
        runs.append(dict(name="karel_compact", dir="karel_compact",
                         dataset_type="karel", steps=DP_STEPS, log_step=1,
                         compact=True))
    runs += list(extra)
    tag = tag or f"dp_demo_{domain}"
    ranks, _ = spawn_ranks(dp * demo_par, backend, dict(
        job or {}, mesh=(dp, demo_par), **{domain: data}, runs=runs), tag,
        device=device, rank_main=_demo_rank)
    trains = [r["name"] for r in runs if r.get("kind", "train") == "train"]
    res = check_demo_ranks(tag, ranks, dp * demo_par, dp, demo_par, backend,
                           trains)
    others = {r["name"]: [rank[r["name"]] for rank in ranks]
              for r in runs if r["name"] not in trains}
    return res, others


def dp_demo_phase(split, vz_train, train_ckpt):
    """The 2-D data x demo mesh on the card (parallel/mesh.py:make_mesh_2d,
    shard_batch_2d, through the port's train and eval steps, as JAX's dry
    run drives its 2-D mesh), gloo with every rank on cuda:0 (NCCL takes
    one card a rank): Karel's full model at dp 2 x demo 2 (world 4),
    DP_STEPS steps on expanded batches and DP_STEPS on the compact wire;
    ViZDoom's at dp 1 x demo 5 (world 5), DP_STEPS steps; each domain also
    DP_BF16_STEPS bf16 steps. Each step within the dtype's STEP_TOL of the
    single process's step from the same parameters, the replicas bitwise
    equal after every step, 125 / 60 launches a rank a step, and the f32
    step's time split into compute, the collectives by group and the
    gradients' all-reduce. In the Karel spawn also the eval step of the
    train phase's checkpoint in every decode mode (eval_2d_run) and one
    step from each 2-D batch source (sources_2d_run)."""
    res = {"card": CARD, "backend": DP_BACKENDS[1]}
    karel, others = demo_spawn(
        "karel", split, DP_BACKENDS[1], extra=[
            bf16_run("karel"),
            dict(name="eval_2d", dir="eval_2d", dataset_type="karel",
                 kind="eval", steps=1, log_step=1),
            dict(name="sources_2d", dir="sources_2d", dataset_type="karel",
                 kind="sources", steps=1, log_step=1)],
        job={"checkpoint": train_ckpt,
             "vizdoom": vz_train.subset(vz_train.ids, "train",
                                        SOURCE_VZD_K)})
    res.update(karel)
    res["eval_2d"] = check_eval_2d(others["eval_2d"])
    res["sources_2d"] = check_sources_2d(others["sources_2d"])
    vizdoom, _ = demo_spawn("vizdoom", vz_train, DP_BACKENDS[1],
                            extra=[bf16_run("vizdoom")])
    res.update(vizdoom)
    print("dp demo " + json.dumps(res), flush=True)
    return res


def recipe_launches(state, per_step, per_sample, test_sample_step):
    """The kernel launches each stage of a recipe state should have made:
    per_step a train step and per_sample a test-sample eval (steps s of
    the stage with s % test_sample_step == 0), per_sample an eval batch."""
    want = []
    for call in state["calls"]:
        for st in call["stages"]:
            if st["kind"] == "train":
                samples = sum(1 for s in range(st["from"], st["to"])
                              if s % test_sample_step == 0)
                want.append((st["to"] - st["from"]) * per_step
                            + samples * per_sample)
            else:
                ev = (state["test"] if st["kind"] == "eval_test"
                      else state["evals"][str(st["step"])])
                want.append(ev["batches"] * per_sample)
    return want


def recipe_phase():
    """Stage S's runner at full width (units 512, bs 32, k 10) on a
    generated 96 / 40 / 40 split (native engine): 40 synthesis steps with a
    checkpoint every 10 and val at 20, 30 and 40 (2 batches of 20 each),
    then the test eval of the selected step, in one process; then the same
    stopped at 20 through --carry_dir and resumed in a fresh directory.
    Both must end with equal train states bit for bit, the same best step
    and the same reports; every stage's launches must follow the formula
    (T + L a step, T + 2L a test-sample eval and an eval batch)."""
    splits = generate_splits(RECIPE_SPLIT, "native")
    check(all(s.id_sha256 == splits[0].id_sha256 for s in splits)
          and [len(s.ids) for s in splits] == [96, 40, 40],
          "the recipe split's parts")
    recipe = dataclasses.replace(recipe_cli.STAGE_S,
                                 split_sha256=splits[0].id_sha256, **RECIPE)
    root = os.path.join(OUT_DIR, "recipe")
    shutil.rmtree(root, ignore_errors=True)
    carry = os.path.join(root, "carry")
    fused_lstm.reset_launches()
    t0 = time.perf_counter()
    one = recipe_cli.RecipeRun(recipe, splits, os.path.join(root, "one"),
                               device=DEVICE).run()
    t_one = time.perf_counter() - t0
    launches_one = fused_lstm.fused_lstm_step.launches
    fused_lstm.reset_launches()
    first = recipe_cli.RecipeRun(
        recipe, splits, os.path.join(root, "a"), device=DEVICE,
        until_step=RECIPE_STAGE_AT, carry_dir=carry).run()
    staged = recipe_cli.RecipeRun(
        recipe, splits, os.path.join(root, "b"), device=DEVICE,
        resume_from=carry).run()
    launches_staged = fused_lstm.fused_lstm_step.launches
    check(first["trained_step"] == RECIPE_STAGE_AT and first["test"] is None,
          f"the first stage ended at {first['trained_step']}")

    cfg = config_from_dataset(trainer_cli.parse_args(
        recipe.trainer_argv("", DEVICE)), splits[0])
    per_step, per_sample = lstm_launches(cfg)
    for name, st, n in (("one process", one, launches_one),
                        ("staged", [first, staged], launches_staged)):
        states = st if isinstance(st, list) else [st]
        have = [c for s in states for call in s["calls"][-1:]
                for c in call["stages"]]
        want = [w for s in states for w in recipe_launches(
            {**s, "calls": s["calls"][-1:]}, per_step, per_sample,
            recipe.test_sample_step)]
        check([h["launches"] for h in have] == want and sum(want) == n,
              f"recipe {name}: launches {[h['launches'] for h in have]}, "
              f"{n} in all, expected {want} ({per_step} a step, "
              f"{per_sample} an eval batch)")
    final = [checkpoint.load(checkpoint.checkpoint_path(
        os.path.join(root, d, "train"), recipe.max_steps))
        for d in ("one", "b")]
    check(equal_states(*final),
          "the staged recipe run's final train state differs from the run "
          "in one process")
    scores = ("execution", "execution_unrounded",
              "greedy_exact_program_accuracy", "greedy_program_seq_acc")
    for key in ("20", "30", "40"):
        check(all(staged["evals"][key][k] == one["evals"][key][k]
                  for k in scores), f"recipe val {key}: staged differs")
    check(staged["best_step"] == one["best_step"] and all(
        staged["test"][k] == one["test"][k] for k in scores),
        "recipe: the staged test report differs")
    check(all(np.isfinite(one["test"][k]) for k in scores[1:]),
          "recipe: non-finite test scores")
    out = {"seconds_one_process": t_one, "best_step": one["best_step"],
           "launches_one_process": launches_one,
           "launches_staged": launches_staged,
           "per_step": per_step, "per_eval_batch": per_sample,
           "val": {k: one["evals"][k]["execution_unrounded"]
                   for k in ("20", "30", "40")},
           "test": {k: one["test"][k] for k in scores},
           "eval_s_per_batch": one["test"]["s_per_batch"],
           "s_per_step": [s["s_per_step"] for s in one["calls"][-1]["stages"]
                          if s["kind"] == "train"]}
    print("recipe " + json.dumps(out), flush=True)
    return out


def cards_main():
    """dp_cards_phase alone, on a machine with several cards (the build,
    the splits, then the phase):

        python3 -c "import chip_smoke; chip_smoke.cards_main()"
    """
    global CARD
    check(torch.cuda.device_count() > 1, "cards_main needs several cards")
    deterministic_cuda()
    full_precision_matmuls()
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", "; ")
    print(CARD, flush=True)
    build_phase()
    split = generate_split(SPLIT)
    vz_train = timed("vizdoom split", vizdoom_split)[0]
    timed("dp cards", dp_cards_phase, split, vz_train)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # as the entry points do, before any CUDA work (cuBLAS reads its
    # workspace config when its first handle is made)
    deterministic_cuda()
    full_precision_matmuls()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    global CARD
    CARD = smi.stdout.strip()
    print(CARD, flush=True)

    t0 = time.perf_counter()
    # the ViZDoom split is made by VZD_WORKERS processes of its own while
    # the phases before ViZDoom's run
    background = concurrent.futures.ThreadPoolExecutor(1)
    vizdoom_job = background.submit(vizdoom_split)
    timed("build", build_phase)
    rows = timed("kernel", kernel_phase)
    split, launches = timed("slice", slice_phase)
    train = timed("train", train_phase, split)
    baselines = timed("baselines", baselines_phase, split)
    decode = timed("decode", decode_phase, split, train["checkpoint"])
    ss = timed("scheduled sampling", train_phase, split, steps=SS_STEPS,
               log_step=SS_LOG_STEP, compare_plain=False, time_steps=False,
               name="full_scheduled", check_falling=False,
               extra_flags=("--scheduled_sampling",
                            "--scheduled_sampling_decay_steps",
                            str(SS_DECAY)))
    resume = timed("resume", resume_phase, "karel", split, split)
    vizdoom_splits = timed("vizdoom split, waited for", vizdoom_job.result)
    background.shutdown()
    vizdoom = timed("vizdoom", vizdoom_phase, *vizdoom_splits)
    bf16 = timed("bf16", bf16_phase, split, vizdoom_splits)
    data = timed("data", data_phase, split, vizdoom_splits)
    dp = timed("dp", dp_phase, split, vizdoom_splits, train["checkpoint"])
    dp_bf16 = timed("dp bf16", dp_bf16_phase, split, vizdoom_splits[0])
    dp_demo = timed("dp demo", dp_demo_phase, split, vizdoom_splits[0],
                    train["checkpoint"])
    if torch.cuda.device_count() > 1:  # NCCL takes a card a rank
        timed("dp cards", dp_cards_phase, split, vizdoom_splits[0])
    recipe = timed("recipe", recipe_phase)
    print(f"phase all: {time.perf_counter() - t0:.1f} s ({CARD})", flush=True)

    def contract(r):  # the contract's names, device times of this run
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
        **contract(main_shape), "shape": [320, 512, UNITS],
        "path_launches": {
            "eval": launches, "train": train["launches"],
            **{name: b["launches"] for name, b in baselines.items()},
            **{f"decode_{m}": d["launches"] for m, d in decode.items()},
            "train_scheduled_sampling": ss["launches"],
            "vizdoom_train": vizdoom["train"]["launches"],
            "vizdoom_beam": vizdoom["beam_launches"],
            **{f"bf16_{k}": n for k, n in bf16["launches"].items()},
            "karel_streaming_train": data["karel"]["launches"],
            "vizdoom_streaming_train": data["vizdoom"]["launches"],
            "profiled_step": data["profiled"]["trace_lstm_kernels"],
            "dp_nccl_world1_train": dp["nccl_world1_launches"],
            "dp_gloo_karel_train_per_rank": dp["karel_launches_per_rank"],
            "dp_gloo_vizdoom_train_per_rank":
                dp["vizdoom_launches_per_rank"],
            **{f"dp_gloo_{n}_train_per_rank": v for n, v in
               dp_bf16["launches_per_rank"].items()},
            **{f"dp_demo_{n}_train_per_rank": dp_demo[n]["launches_per_rank"]
               for n in ("karel", "karel_compact", "vizdoom", "karel_bf16",
                         "vizdoom_bf16")},
            **{f"dp_demo_eval_{m}_per_rank": r["launches_per_rank"]
               for m, r in dp_demo["eval_2d"].items()},
            "recipe_one_process": recipe["launches_one_process"],
            "recipe_staged": recipe["launches_staged"]},
        "shapes": [dict(r, **contract(r)) for r in rows]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
