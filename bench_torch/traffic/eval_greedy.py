"""Traffic driver: greedy evaluation of a trained checkpoint, as
`Evaler.eval_run` runs its loop (eval/evaler.py: `fetch_batch`,
`to_device`, `eval_step`, the copy of the evals to the host, and
`scorer.score_batch`: syntax, exact program, and the VM's execution of
each decoded program on the seen and unseen demos).

Parameters (the cell file's `params`):
  programs         the test pool's size, a whole number of batches,
                   generated with the native engine from `data_seed`
  data_seed        the pool's seed, fixed: every run scores the same
                   programs, so the seed does not change the work
  pool_sha256      the pool's contents (pool_digest), checked at set-up:
                   a change to the program's generator cannot change the
                   cell's traffic unseen
  warmup_batches   batches run before the window
  profile_batches  batches profiled in a `--trace 1` run, after the window
  sample_batches   window batches the reference scores again, drawn from
                   the seed, the one with the longest decoded program
                   among them

The run's seed orders the pool's batches, a new permutation each pass
over it. The checkpoint is the configuration's committed file; its sha256
is checked before it is loaded. The window scores batches for `--seconds`
and ends at the end of the last completed batch.
"""

import gc
import hashlib
import time

import numpy as np
import torch

from bench_torch.harness import karel
from bench_torch.harness.bench import ROOT
from bench_torch.harness.trace import Trace
from bench_torch.reference import karel_model as ref
from bench_torch.reference import karel_scoring


def checkpoint_path(cfg):
    """The configuration's checkpoint, refused unless its sha256 is the
    one the configuration records."""
    path = ROOT / cfg["checkpoint"]["file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != cfg["checkpoint"]["sha256"]:
        raise ValueError(f"{path}: sha256 {digest}, not the configuration's "
                         f"{cfg['checkpoint']['sha256']}")
    return path


def pool_digest(split):
    """sha256 (hex) of a split's ids and arrays, in the order of their
    names."""
    h = hashlib.sha256()
    for id_ in split.ids:
        h.update((id_ + "\n").encode())
    for key in sorted(split.arr):
        a = np.ascontiguousarray(split.arr[key])
        h.update(f"{key} {a.dtype} {a.shape}\n".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def batch_order(n, seed):
    """Batch indices of a pool of n batches: each pass a permutation drawn
    from the seed."""
    rng = np.random.default_rng(seed)
    while True:
        yield from (int(b) for b in rng.permutation(n))


def _batch(evaler, split, b, bs, device):
    """One pass of the eval loop's body over batch b -> its record."""
    from demo2program_tpu_torch.eval.evaler import fetch_batch
    from demo2program_tpu_torch.train.step import to_device

    t0 = time.perf_counter()
    vm0 = evaler.scorer.timings["vm"]
    ids = split.ids[b * bs:(b + 1) * bs]
    raw = fetch_batch(split, ids, "karel")
    batch = to_device(raw, device)
    report, evals = evaler.eval_step(batch)
    report = {k: float(v) for k, v in report.items()}
    evals = {k: v.cpu().numpy() for k, v in evals.items()}
    forward = time.perf_counter() - t0
    scores = evaler.scorer.score_batch(batch, evals)
    return {"ids": ids, "loss": report["program_loss"],
            "greedy_loss": float(evals["greedy_program_loss"]),
            "tokens": evals["greedy_tokens"], "len": evals["greedy_len"],
            "syntax": scores["greedy_is_correct_syntax"],
            "exact": scores["greedy_exact_program_correct"],
            "seen": scores["greedy_program_is_correct_execution"],
            "unseen": scores["test_greedy_program_num_execution_correct"],
            "forward_s": forward,
            "vm_s": evaler.scorer.timings["vm"] - vm0,
            "end": time.perf_counter()}


def run(ctx):
    p, cfg = ctx.params, ctx.config
    path = checkpoint_path(cfg)
    split = karel.make_split(cfg, p["programs"], p["data_seed"])
    if "pool_sha256" in p and pool_digest(split) != p["pool_sha256"]:
        raise ValueError(f"the pool of data_seed {p['data_seed']} reads "
                         f"sha256 {pool_digest(split)}, not the cell's "
                         f"{p['pool_sha256']}: the generator has changed")
    evaler = karel.make_evaler(cfg, ctx, split, path)
    bs = cfg["eval_batch_size"]
    order = batch_order(len(split.ids) // bs, ctx.seed_for("order"))
    for _ in range(p["warmup_batches"]):
        _batch(evaler, split, next(order), bs, ctx.device)

    setup_s = ctx.setup_s()
    t0 = time.perf_counter()
    done = []
    while time.perf_counter() - t0 < ctx.seconds:
        done.append(_batch(evaler, split, next(order), bs, ctx.device))
    window = done[-1]["end"] - t0

    layer = {"forward_s": [r["forward_s"] for r in done],
             "vm_s": [r["vm_s"] for r in done]}
    if ctx.trace:
        with Trace(ctx.device) as tr:
            for _ in range(p["profile_batches"]):
                _batch(evaler, split, next(order), bs, ctx.device)
        layer.update(tr.reduce() or {}, traced_steps=p["profile_batches"],
                     step_s=window / len(done))
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(ctx.device).type == "cuda" else 0)
    del evaler
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()

    picked = sample(done, p["sample_batches"], ctx.seed_for("sample"))
    numbers = compare(cfg, path, split, [done[i] for i in picked],
                      ctx.device)
    return {
        "attempted": len(done) * bs, "failed": 0,
        "e2e": {"eval_programs_per_s": len(done) * bs / window,
                "setup_s": setup_s},
        "numbers": numbers, "layer": layer, "memory_peak_bytes": peak}


def sample(done, n, seed):
    """Indices of n window batches of different programs drawn from the
    seed, the batch with the longest decoded program first."""
    first = {}
    for i, r in enumerate(done):
        first.setdefault(r["ids"][0], i)
    distinct = sorted(first.values())
    longest = max(distinct, key=lambda i: done[i]["len"].max())
    rest = [i for i in distinct if i != longest]
    rng = np.random.default_rng(seed)
    picked = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(int(i) for i in picked)


def reference_weights(path, cfg, device):
    """The checkpoint's weights and batch-norm statistics, read by the
    reference itself."""
    state = torch.load(path, map_location=device, weights_only=True)
    state = state.get("model", state)
    names = [n for n, _, _ in ref.param_specs(cfg)]
    w = {n: state[n].float() for n in names}
    stats = {n: v.float() for n, v in state.items() if "running" in n}
    return w, stats


def compare(cfg, path, split, records, device):
    """The program's readings against the plain reference's on the sampled
    batches -> {number: value}:

      loss_gap            the widest relative gap of a batch's teacher-
                          forced program loss;
      greedy_loss_gap     the same of the greedy logits' loss against the
                          ground truth (the decode path's logits);
      token_mismatches    examples with a served token (before its served
                          length) that is not the reference's first at its
                          position, fed along the served tokens;
      verdict_mismatches  examples whose execution verdicts (each seen
                          demo, the count of unseen demos) differ;
      syntax_mismatches   examples whose syntax or exact-program verdicts
                          differ;
      token_gap           the widest gap by which a served token's logit
                          lies below the reference's best (reported, not
                          compared: the TF32 control reads 0 on it)."""
    w, stats = reference_weights(path, cfg, device)
    ar = ref.Arith()
    out = {"loss_gap": 0.0, "greedy_loss_gap": 0.0, "token_mismatches": 0,
           "verdict_mismatches": 0, "syntax_mismatches": 0, "token_gap": 0.0}
    for r in records:
        compact = split.get_batch_compact(r["ids"])
        loss, along, greedy = ref.eval_logits(w, stats, cfg, compact,
                                              r["tokens"], ar, device)
        out["loss_gap"] = max(out["loss_gap"], abs(r["loss"] - loss) / loss)
        out["greedy_loss_gap"] = max(out["greedy_loss_gap"],
                                     abs(r["greedy_loss"] - greedy) / greedy)
        gaps = ref.widest_gaps(along, r["tokens"], r["len"])
        out["token_gap"] = max(out["token_gap"], float(gaps.max()))
        out["token_mismatches"] += int(np.sum(gaps > 0))
        s = karel_scoring.score(compact, r["tokens"], r["len"])
        out["verdict_mismatches"] += int(np.sum(
            (s["seen"] != r["seen"].astype(bool)).any(1)
            | (s["unseen"] != r["unseen"])))
        out["syntax_mismatches"] += int(np.sum(
            (s["syntax"] != r["syntax"]) | (s["exact"] != r["exact"])))
    return out
