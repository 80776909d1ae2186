"""Stage S of the JAX package's Karel recipe on the port: train the
synthesis baseline on karel_25k, evaluate val at three checkpoints, pick
one, evaluate it on the test split.

    python -m demo2program_tpu_torch.cli.recipe_cli --out_dir runs/stage_s

The recipe is `STAGE_S`, the values of scripts/round5_chain.sh:130-168:
30000 steps of `synthesis_baseline` at k 10 with the staircase learning
rate (`--lr_weight_decay`), seed 234, a checkpoint every 5000 steps; val
evals of the checkpoints at 20000, 25000 and 30000 over 64 batches of 20;
then the test eval of the step whose printed last bin of
`test_greedy_program_execution_acc_hist` is highest (`select_step`, the
earliest on a tie, as the script's `acc > best_acc`) over the whole test
split. Trainer and Evaler are built from trainer_cli's and evaler_cli's
parsers, as the CLIs build them.

The data is made in memory (data/karel_memory.py:generate_splits, native
engine, karel_25k's 25000 / 5000 / 5000 programs from seed 123), so no
HDF5 file and no h5py are needed. The run refuses to train unless the
id list hashes to the recipe's `split_sha256`, the sha256 of the JAX
package's karel_25k id.txt: the run trains on that dataset, id for id.
`--split_file F` reads the splits from F when it exists (save_splits'
.npz), else generates them and writes F; the state records the contents'
hash of the split it was made on (splits_sha256) and refuses another.

Stages. The run may span processes, and machines whose disks do not outlive
a process:
  * `--budget_minutes M` does, from the start of the process (generation
    included), only what fits in M minutes: training goes a test-sample
    interval (1000 steps) at a time, each ending in a checkpoint, and an
    interval is trained only when it fits with the val eval it ends on;
    the times come from this run's own rates (priors until it has them).
    `--until_step S` stops training at S. One Trainer serves a process.
  * `<out_dir>/recipe_state.json` records the split's sha256, each train
    stage, each eval's report and the test report. A relaunch does only
    what is left; a state made on another split or another recipe is
    refused. Training resumes from the newest checkpoint, exactly
    (train/trainer.py, resume.json).
  * `--carry_dir D` writes what the next process needs after each stage:
    the newest train checkpoint, the model of the best val step so far
    (`best/<step>.pt`), the state, the summaries, metrics.jsonl and the
    report. `--resume_from D` copies it into a fresh `--out_dir`.

Outputs: each eval's summary file `summaries/out_<step>_<split>.txt`
(Evaler.write_summary) and `recipe_report.json`: per eval the execution on
unseen demos (the last histogram bin), exact program and sequence
accuracy, seconds a batch split into forward, vm and host
(Evaler.timings), and the fused LSTM kernel's launches; per train stage its
steps, seconds and launches; and the card's name and power limit
(nvidia-smi). `--device cuda` is the default; without a card it raises, and
nothing falls back to the python generator.
"""

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass

import torch

from demo2program_tpu_torch.cli import evaler_cli, trainer_cli
from demo2program_tpu_torch.data.karel_generator import GeneratorConfig
from demo2program_tpu_torch.data.karel_memory import (
    generate_splits, load_splits, save_splits, splits_sha256)
from demo2program_tpu_torch.eval.evaler import Evaler
from demo2program_tpu_torch.ops import fused_lstm
from demo2program_tpu_torch.train import checkpoint
from demo2program_tpu_torch.train.step import (
    deterministic_cuda, full_precision_matmuls, resolve_device)
from demo2program_tpu_torch.train.trainer import Trainer
from demo2program_tpu_torch.utils import log

KAREL_25K_ID_SHA256 = (
    "ee199a6669b219f5a9e5bed4fc69deb7354a7ab04196b186c672b52bfda5ad49")

# the JAX recipe's seed-123 row (RESULTS.md:180): the bar on the test split
BAR = {"execution": 0.637, "greedy_exact_program_accuracy": 0.424,
       "greedy_program_seq_acc": 0.354}

HIST_KEY = "test_greedy_program_execution_acc_hist"

# time estimates before the run has its own (s a train step, s an eval
# batch), and the time kept back for writing the carry
PRIOR_S_PER_STEP = 0.1
PRIOR_S_PER_EVAL_BATCH = 3.0
MARGIN_S = 60.0


class RecipeRefused(ValueError):
    """The split or the state is not the recipe's."""


@dataclass(frozen=True)
class Recipe:
    model: str = "synthesis_baseline"
    num_k: int = 10
    max_steps: int = 30000
    seed: int = 234
    lr_weight_decay: bool = True
    ckpt_save_step: int = 5000
    test_sample_step: int = 1000
    log_step: int = 100
    cell_impl: str = "pallas"
    batch_size: int = 32
    num_lstm_cell_units: int = 512
    val_steps: tuple = (20000, 25000, 30000)
    val_batches: int = 64
    eval_batch_size: int = 20
    split_sha256: str = KAREL_25K_ID_SHA256  # "" takes any split

    def trainer_argv(self, train_dir, device):
        return [
            "--model", self.model, "--dataset_type", "karel",
            "--dataset_path", "in-memory", "--num_k", str(self.num_k),
            "--max_steps", str(self.max_steps), "--seed", str(self.seed),
            "--train_dir", train_dir,
            "--ckpt_save_step", str(self.ckpt_save_step),
            "--test_sample_step", str(self.test_sample_step),
            "--log_step", str(self.log_step), "--cell_impl", self.cell_impl,
            "--batch_size", str(self.batch_size),
            "--num_lstm_cell_units", str(self.num_lstm_cell_units),
            "--device", device,
            *(["--lr_weight_decay"] if self.lr_weight_decay else [])]

    def evaler_argv(self, checkpoint, split, batches, summary_file, device):
        return [
            "--model", self.model, "--dataset_type", "karel",
            "--dataset_path", "in-memory", "--num_k", str(self.num_k),
            "--checkpoint", checkpoint, "--dataset_split", split,
            "--max_steps", str(batches), "--cell_impl", self.cell_impl,
            "--batch_size", str(self.eval_batch_size),
            "--num_lstm_cell_units", str(self.num_lstm_cell_units),
            "--summary_file", summary_file, "--quiet", "--device", device]


STAGE_S = Recipe()


def printed_execution(text):
    """The last bin of the last `test_greedy_program_execution_acc_hist`
    line of a report, as printed (3 decimals), or None: the JAX script's
    `float(ms[-1].split(",")[-2])`."""
    ms = re.findall(HIST_KEY + r": \[([^\]]*)\]", text)
    if not ms:
        return None
    return float(ms[-1].split(",")[-2])


def select_step(texts, default):
    """{step: report text} in the recipe's val order -> (step, printed
    execution): the highest printed value, the earliest step on a tie
    (scripts/round5_chain.sh:146-163); `default` and None when no report
    has the line."""
    best_step, best_acc = None, -1.0
    for step, text in texts.items():
        acc = printed_execution(text)
        if acc is not None and acc > best_acc:
            best_step, best_acc = step, acc
    if best_step is None:
        return default, None
    return best_step, best_acc


def card_name(device):
    """nvidia-smi's "name, power.limit" of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _mean(xs):
    return sum(xs) / len(xs) if xs else 0.0


def _launches():
    return fused_lstm.fused_lstm_step.launches


class RecipeRun:
    """One process's share of a recipe run in `out_dir`: `run()` does what
    is left and fits, and returns the state."""

    def __init__(self, recipe, splits, out_dir, device="cuda",
                 budget_s=None, until_step=None, carry_dir=None,
                 resume_from=None, started=None, generation=None):
        self.recipe = recipe
        self.train_split, self.test_split, self.val_split = splits
        self.out_dir = out_dir
        self.device = resolve_device(device)
        self.budget_s = budget_s
        self.until_step = until_step
        self.carry_dir = carry_dir
        self.started = time.monotonic() if started is None else started
        self.train_dir = os.path.join(out_dir, "train")
        self.state_path = os.path.join(out_dir, "recipe_state.json")

        sha = self.train_split.id_sha256
        if recipe.split_sha256 and sha != recipe.split_sha256:
            raise RecipeRefused(
                f"the split's id list hashes to {sha}, not the recipe's "
                f"{recipe.split_sha256}: it is not the recipe's dataset")
        if resume_from:
            if os.path.exists(self.state_path):
                raise RecipeRefused(f"{out_dir} already holds a state; "
                                    f"resume into a fresh directory")
            shutil.copytree(resume_from, out_dir, dirs_exist_ok=True)
        os.makedirs(self.train_dir, exist_ok=True)
        self.state = self._load_state(sha, splits_sha256(splits))
        self.card = card_name(self.device)
        self.call = {"card": self.card, "started": time.time(),
                     "generation": generation, "stages": []}
        self.trainer = None
        self.state["calls"].append(self.call)

    # -- state -----------------------------------------------------------
    def _load_state(self, sha, content_sha):
        recipe = dataclasses.asdict(self.recipe)
        recipe["val_steps"] = list(recipe["val_steps"])
        if not os.path.exists(self.state_path):
            return {"recipe": recipe, "split_sha256": sha,
                    "split_content_sha256": content_sha, "trained_step": 0,
                    "evals": {}, "best_step": None, "best_execution": None,
                    "test": None, "calls": []}
        with open(self.state_path) as f:
            state = json.load(f)
        if state["split_sha256"] != sha:
            raise RecipeRefused(
                f"{self.state_path} was made on a split whose id list "
                f"hashes to {state['split_sha256']}; this split's is {sha}")
        if state["split_content_sha256"] != content_sha:
            raise RecipeRefused(
                f"{self.state_path} was made on a split whose contents hash "
                f"to {state['split_content_sha256']}; this split's to "
                f"{content_sha}")
        if state["recipe"] != recipe:
            raise RecipeRefused(f"{self.state_path} was made by another "
                                f"recipe: {state['recipe']}")
        return state

    def _save(self):
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=1)
        os.replace(tmp, self.state_path)
        self._write_report()
        if self.carry_dir:
            self._write_carry()

    def _write_report(self):
        st = self.state
        test = st["test"]
        report = {
            "recipe": st["recipe"], "split_sha256": st["split_sha256"],
            "split_content_sha256": st["split_content_sha256"],
            "evals": [st["evals"][k] for k in sorted(st["evals"], key=int)],
            "best_step": st["best_step"], "test": test, "bar": BAR,
            "meets_bar": (None if test is None else all(
                test[k] >= v for k, v in BAR.items())),
            "stages": [dict(s, card=c["card"]) for c in st["calls"]
                       for s in c["stages"]]}
        with open(os.path.join(self.out_dir, "recipe_report.json"), "w") as f:
            json.dump(report, f, indent=1)

    def _write_carry(self):
        """What the next process needs, under carry_dir (replaced whole):
        the newest train checkpoint and everything else but the older
        checkpoints."""
        latest = checkpoint.latest_checkpoint(self.train_dir)
        ckpt_dir = os.path.join(self.train_dir, checkpoint.CKPT_DIR)

        def ignore(path, names):
            if os.path.abspath(path) != os.path.abspath(ckpt_dir):
                return []
            return [n for n in names if n != os.path.basename(latest)]

        tmp = self.carry_dir.rstrip("/") + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.copytree(self.out_dir, tmp, ignore=ignore)
        shutil.rmtree(self.carry_dir, ignore_errors=True)
        os.replace(tmp, self.carry_dir)

    # -- timing ----------------------------------------------------------
    def _left(self):
        if self.budget_s is None:
            return float("inf")
        return self.budget_s - (time.monotonic() - self.started) - MARGIN_S

    def _s_per_step(self):
        """Seconds a step over every train stage so far."""
        stages = [s for c in self.state["calls"] for s in c["stages"]
                  if s["kind"] == "train" and s["to"] > s["from"]]
        if not stages:
            return PRIOR_S_PER_STEP
        return (sum(s["seconds"] for s in stages)
                / sum(s["to"] - s["from"] for s in stages))

    def _eval_s(self, batches):
        """Seconds of an eval of `batches` at the rate of every eval so
        far."""
        evals = list(self.state["evals"].values())
        if self.state["test"]:
            evals.append(self.state["test"])
        if not evals:
            return batches * PRIOR_S_PER_EVAL_BATCH
        return batches * (sum(e["seconds"] for e in evals)
                          / sum(e["batches"] for e in evals))

    # -- the pieces ------------------------------------------------------
    def _trained(self):
        steps = checkpoint.checkpoint_steps(self.train_dir)
        return steps[-1] if steps else 0

    def _train_to(self, stop):
        start = self._trained()
        n0, t0 = _launches(), time.monotonic()
        if self.trainer is None:  # resumes from the newest checkpoint
            args = trainer_cli.parse_args(self.recipe.trainer_argv(
                self.train_dir, self.device.type))
            self.trainer = Trainer(args, self.train_split, self.test_split,
                                   device=args.device)
        self.trainer.train(
            max_steps=self.recipe.max_steps - self.trainer.state.step,
            stop_at=stop)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.monotonic() - t0
        self.state["trained_step"] = self._trained()
        self.call["stages"].append({
            "kind": "train", "from": start, "to": self.state["trained_step"],
            "seconds": seconds, "launches": _launches() - n0,
            "s_per_step": seconds / max(stop - start, 1)})
        log.infov("recipe: trained %d -> %d in %.1f s", start, stop, seconds)

    def _evaluate(self, step, split_name, ckpt_path, batches):
        """One eval through evaler_cli's parser and the Evaler -> its
        report (the summary written to summaries/out_<step>_<split>.txt)."""
        split = {"val": self.val_split, "test": self.test_split}[split_name]
        summary = os.path.join(self.out_dir, "summaries",
                               f"out_{step}_{split_name}.txt")
        os.makedirs(os.path.dirname(summary), exist_ok=True)
        args = evaler_cli.parse_args(self.recipe.evaler_argv(
            ckpt_path, split_name, batches, summary, self.device.type))
        n0, t0 = _launches(), time.monotonic()
        evaler = Evaler(args, split, device=args.device)
        _, acc, hist = evaler.eval_run()
        seconds = time.monotonic() - t0
        with open(summary) as f:
            text = f.read()
        tm = evaler.timings
        report = {
            "step": step, "split": split_name, "batches": batches,
            "batch_size": self.recipe.eval_batch_size,
            "execution": printed_execution(text),
            "execution_unrounded": float(hist[HIST_KEY][-1]),
            "greedy_exact_program_accuracy": float(
                acc["greedy_exact_program_accuracy"]),
            "greedy_program_seq_acc": float(acc["greedy_program_seq_acc"]),
            "s_per_batch": {k: _mean(tm[k]) for k in
                            ("batch", "forward", "vm", "host")},
            "seconds": seconds, "launches": _launches() - n0}
        self.call["stages"].append({
            "kind": f"eval_{split_name}", "step": step, "seconds": seconds,
            "launches": report["launches"]})
        log.infov("recipe: %s eval of step %d: execution %.3f, exact %.3f, "
                  "sequence %.3f (%.1f s)", split_name, step,
                  report["execution_unrounded"],
                  report["greedy_exact_program_accuracy"],
                  report["greedy_program_seq_acc"], seconds)
        return report

    def _val(self, step):
        path = checkpoint.checkpoint_path(self.train_dir, step)
        self.state["evals"][str(step)] = self._evaluate(
            step, "val", path, self.recipe.val_batches)
        best, acc = select_step(self._val_texts(), self.recipe.max_steps)
        if best == step:  # keep this step's model, drop the one it beat
            best_dir = os.path.join(self.out_dir, "best")
            shutil.rmtree(best_dir, ignore_errors=True)
            os.makedirs(best_dir)
            checkpoint.save(checkpoint.model_state_dict(checkpoint.load(
                path)), os.path.join(best_dir, f"{step}.pt"))
        self.state["best_step"], self.state["best_execution"] = best, acc

    def _val_texts(self):
        texts = {}
        for step in self.recipe.val_steps:
            path = os.path.join(self.out_dir, "summaries",
                                f"out_{step}_val.txt")
            if str(step) in self.state["evals"] and os.path.exists(path):
                with open(path) as f:
                    texts[step] = f.read()
        return texts

    def _test(self):
        best, _ = select_step(self._val_texts(), self.recipe.max_steps)
        path = os.path.join(self.out_dir, "best", f"{best}.pt")
        if not os.path.exists(path):  # no val eval: the final checkpoint
            path = checkpoint.checkpoint_path(self.train_dir, best)
        batches = len(self.test_split.ids) // self.recipe.eval_batch_size
        self.state["best_step"] = best
        self.state["test"] = self._evaluate(best, "test", path, batches)

    # -- the loop --------------------------------------------------------
    def run(self):
        r = self.recipe
        self._save()
        while True:
            trained = self._trained()
            due = [v for v in r.val_steps
                   if v <= trained and str(v) not in self.state["evals"]]
            if due:
                if self._eval_s(r.val_batches) > self._left():
                    log.infov("recipe: the val eval of step %d does not fit "
                              "the budget; stopping", due[0])
                    break
                self._val(due[0])
            elif trained < r.max_steps:
                stop = min(trained - trained % r.test_sample_step
                           + r.test_sample_step, r.max_steps)
                if self.until_step is not None and stop > self.until_step:
                    break
                need = (stop - trained) * self._s_per_step()
                if stop in r.val_steps:
                    need += self._eval_s(r.val_batches)
                if need > self._left():
                    log.infov("recipe: training to step %d does not fit the "
                              "budget; stopping at %d", stop, trained)
                    break
                self._train_to(stop)
            elif self.state["test"] is None:
                batches = (len(self.test_split.ids)
                           // r.eval_batch_size)
                if self._eval_s(batches) > self._left():
                    log.infov("recipe: the test eval does not fit the "
                              "budget; stopping")
                    break
                self._test()
            else:
                log.infov("recipe: done; test report in %s",
                          os.path.join(self.out_dir, "recipe_report.json"))
                break
            self._save()
        self._save()
        return self.state


def build_parser():
    d = STAGE_S
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--budget_minutes", type=float, default=None,
                   help="do only what fits in this many minutes of the "
                        "process, generation included")
    p.add_argument("--until_step", type=int, default=None,
                   help="train no further than this step")
    p.add_argument("--carry_dir", type=str, default=None,
                   help="write what a later process needs here")
    p.add_argument("--resume_from", type=str, default=None,
                   help="a --carry_dir of an earlier process, copied into "
                        "a fresh --out_dir")
    # a smaller run of the same recipe (the defaults are stage S's)
    for name in ("max_steps", "ckpt_save_step", "test_sample_step",
                 "log_step", "val_batches", "batch_size", "eval_batch_size",
                 "num_lstm_cell_units"):
        p.add_argument("--" + name, type=int, default=getattr(d, name))
    p.add_argument("--val_steps", type=str,
                   default=",".join(map(str, d.val_steps)))
    p.add_argument("--split_sha256", type=str, default=d.split_sha256,
                   help="the id list's sha256 the run must train on; '' "
                        "takes any split")
    p.add_argument("--split_file", type=str, default=None,
                   help="an .npz of the three splits: read when it exists "
                        "(the state holds it to the contents of the split it "
                        "was made on), else generated and written there")
    for name in ("num_train", "num_test", "num_val"):  # the generator's
        p.add_argument("--" + name, type=int, default=None)
    return p


def recipe_of(args):
    fields = {f.name for f in dataclasses.fields(Recipe)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    kw["val_steps"] = tuple(int(s) for s in args.val_steps.split(",") if s)
    return dataclasses.replace(STAGE_S, **kw)


def main(argv=None):
    started = time.monotonic()
    args = build_parser().parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        deterministic_cuda()
    full_precision_matmuls()
    recipe = recipe_of(args)
    sizes = {k: getattr(args, k) for k in ("num_train", "num_test", "num_val")
             if getattr(args, k) is not None}
    gen_cfg = dataclasses.replace(GeneratorConfig(), **sizes)
    t0 = time.monotonic()
    if args.split_file and os.path.exists(args.split_file):
        splits, how = load_splits(args.split_file), "read"
    else:
        splits, how = generate_splits(gen_cfg, "native",
                                      progress_every=5000), "generated"
        if args.split_file:
            save_splits(splits, args.split_file)
    generation = {"how": how, "programs": sum(len(s.ids) for s in splits),
                  "seconds": time.monotonic() - t0,
                  "id_sha256": splits[0].id_sha256}
    log.infov("recipe: %(how)s %(programs)d programs in %(seconds).1f s; id "
              "list sha256 %(id_sha256)s", generation)
    RecipeRun(recipe, splits, args.out_dir, device=args.device,
              budget_s=(None if args.budget_minutes is None
                        else args.budget_minutes * 60),
              until_step=args.until_step, carry_dir=args.carry_dir,
              resume_from=args.resume_from, started=started,
              generation=generation).run()


if __name__ == "__main__":
    main()
