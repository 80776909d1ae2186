"""Evaluation entry point of the port: the model families `--model full |
synthesis_baseline | summarizer | induction_baseline` (default full) on
`--dataset_type karel | vizdoom`; an induction checkpoint reports action
accuracies and no program ones.

    python -m demo2program_tpu_torch.cli.evaler_cli \
        --dataset_path datasets/karel_dataset --checkpoint model.pt \
        --model synthesis_baseline

Flags follow demo2program_tpu/cli/evaler_cli.py (the shared
cli/flags.py parser, the port's copy), plus `--device {cuda,cpu}` (default
cuda; without a card, cuda raises). `--checkpoint` takes a trainer
checkpoint or a bare state_dict; `--train_dir` evaluates its newest
checkpoint. `--unroll_type {greedy,syntax_greedy,syntax_sample,beam}`
picks the program decoding, `--beam_width` the beams and
`--execution_rerank` the beam that reproduces the seen demos; on ViZDoom,
`--rerank_k N` checks the beams against N stored seen demos. Without
`--max_steps` the whole split is evaluated, and the default summary file
is named after that many batches, as in the JAX CLI. On the card, kernels
run in deterministic mode (train/step.py:deterministic_cuda).

`--pred_program` dumps every example's programs and verdicts to
`<output_dir>/out_<ckpt>_<split>.{txt,hdf5,log}` (output_dir defaults to
the train_dir, else "."), `--result_data` writes `--result_data_path` with
the decoded programs beside the stored demos, `--id_list FILE` evaluates the
ids listed in FILE (an unknown id raises). `--sweep_steps 10,20,...`
evaluates those checkpoints of `--train_dir` (`ckpt/<step>.pt`) in one
process with one Evaler: a step whose `out_<step>_<split>.log` already
holds a Final Avg Report is skipped, a missing checkpoint is skipped with a
warning, and each step writes its own summary file (with `--summary_file
NAME` the step goes into the name, `NAME.<step>`: the JAX sweep overwrites
one file). `--no_loss` and `--unseen_test` are parsed and unused, as in
JAX. Reading an HDF5 dataset and writing the dumps need h5py.
"""

import os
import re

from demo2program_tpu_torch.cli.flags import base_parser
from demo2program_tpu_torch.utils import log


def build_parser():
    p = base_parser()
    p.set_defaults(batch_size=20)
    p.add_argument("--dataset_split", type=str, default="test",
                   choices=["train", "test", "val"])
    p.add_argument("--train_dir", type=str, default="",
                   help="evaluate the newest checkpoint in this train_dir")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--output_dir", type=str, default=None,
                   help="where --pred_program writes; default: the "
                        "train_dir, else the working directory")
    p.add_argument("--max_steps", type=int, default=0,
                   help="number of batches; 0 = the whole split")
    p.add_argument("--no_loss", action="store_true", default=False,
                   help="parsed and unused, as in the reference")
    p.add_argument("--pred_program", action="store_true", default=False,
                   help="write out_<ckpt>_<split>.txt/.hdf5/.log (needs "
                        "h5py)")
    p.add_argument("--result_data", action="store_true", default=False,
                   help="write --result_data_path (needs h5py)")
    p.add_argument("--result_data_path", type=str, default="result.hdf5")
    p.add_argument("--id_list", type=str, default=None,
                   help="file of ids, one a line, to evaluate instead of "
                        "the split")
    p.add_argument("--unseen_test", action="store_true", default=False,
                   help="parsed and unused, as in the reference")
    p.add_argument("--quiet", action="store_true", default=False)
    p.add_argument("--unroll_type", type=str, default="greedy",
                   choices=["greedy", "syntax_greedy", "syntax_sample",
                            "beam"],
                   help="program decoding mode; syntax_* mask each step to "
                        "the grammar-legal tokens (pushdown on the device); "
                        "beam = beam search (--beam_width)")
    p.add_argument("--beam_width", type=int, default=5)
    p.add_argument("--execution_rerank", action="store_true", default=False,
                   help="with --unroll_type beam: report, as the decoded "
                        "program, the highest-scoring beam that reproduces "
                        "all SEEN demos")
    p.add_argument("--rerank_k", type=int, default=0,
                   help="verify reranked beams against this many stored "
                        "seen demos instead of --num_k (vizdoom only; the "
                        "extra demos belong to the same task and carry no "
                        "test-demo information). 0 = use num_k")
    p.add_argument("--no_write_summary", action="store_true", default=False)
    p.add_argument("--summary_file", type=str, default=None)
    p.add_argument("--sweep_steps", type=str, default="",
                   help="comma-separated checkpoint steps of --train_dir to "
                        "evaluate in ONE process with one Evaler; steps "
                        "whose out_<step>_<split>.log holds a Final Avg "
                        "Report are skipped, missing checkpoints are "
                        "skipped with a warning")
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.write_summary = not args.no_write_summary
    if args.output_dir is None:
        args.output_dir = args.train_dir or "."
    return args


def apply_id_list(args, target):
    """--id_list: evaluate the ids the file lists; an unknown id raises."""
    if not args.id_list:
        return
    from demo2program_tpu_torch.data.dataset import check_data_id
    with open(args.id_list) as f:
        wanted = [line.strip() for line in f if line.strip()]
    check_data_id(target, wanted)
    target._ids = wanted


def sweep_todo(args):
    """[(step, checkpoint path)] of --sweep_steps still to evaluate."""
    from demo2program_tpu_torch.train import checkpoint
    if not args.train_dir:
        raise SystemExit("--sweep_steps requires --train_dir")
    todo = []
    for step in (int(s) for s in args.sweep_steps.split(",") if s.strip()):
        path = checkpoint.checkpoint_path(os.path.abspath(args.train_dir),
                                          step)
        if not os.path.isfile(path):
            log.warn("sweep: no checkpoint at step %d; skipping", step)
            continue
        out = os.path.join(args.output_dir,
                           f"out_{step}_{args.dataset_split}.log")
        try:
            with open(out) as f:
                done = re.search(r"Final Avg Report", f.read())
        except OSError:
            done = None
        if done:
            log.info("sweep: step %d already evaluated; skipping", step)
            continue
        todo.append((step, path))
    return todo


def run_sweep(args, target, device):
    """Evaluate every checkpoint of `sweep_todo` with ONE Evaler (model,
    eval step and scorer are built once; each further step only loads its
    weights) -> {step: eval_run's result}. `--summary_file NAME` becomes
    NAME.<step> for each step."""
    from demo2program_tpu_torch.eval.evaler import Evaler
    todo = sweep_todo(args)
    if not todo:
        log.infov("sweep: nothing to do")
        return {}
    args.checkpoint = todo[0][1]
    summary_file = args.summary_file
    evaler = Evaler(args, target, device=device)
    log.warning("dataset: %s", args.dataset_path)
    results = {}
    for step, path in todo:
        if path != evaler.checkpoint:
            evaler.set_checkpoint(path)
        if summary_file:
            args.summary_file = f"{summary_file}.{step}"
        results[step] = evaler.eval_run()
    args.summary_file = summary_file
    return results


def read_splits(args, is_train):
    """(train, test, val) splits of the HDF5 dataset at args.dataset_path."""
    if args.dataset_type == "vizdoom":
        from demo2program_tpu_torch.data import vizdoom_dataset
        return vizdoom_dataset.create_vizdoom_splits(
            args.dataset_path, num_k=args.num_k, is_train=is_train)
    from demo2program_tpu_torch.data import dataset
    return dataset.create_default_splits(args.dataset_path, num_k=args.num_k,
                                         is_train=is_train)


def main(argv=None):
    from demo2program_tpu_torch.eval.evaler import Evaler
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, full_precision_matmuls, resolve_device)

    args = parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        deterministic_cuda()
    # no TF32, and bf16 GEMMs that reduce in f32
    full_precision_matmuls()
    splits = read_splits(args, is_train=False)
    target = dict(zip(["train", "test", "val"], splits))[args.dataset_split]
    apply_id_list(args, target)
    if not args.max_steps > 0:
        args.max_steps = len(target.ids) // args.batch_size
    if args.sweep_steps:
        run_sweep(args, target, args.device)
        return
    evaler = Evaler(args, target, device=args.device)
    log.warning("dataset: %s", args.dataset_path)
    evaler.eval_run()


if __name__ == "__main__":
    main()
