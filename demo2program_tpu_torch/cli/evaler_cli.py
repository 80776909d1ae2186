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
run in deterministic mode (train/step.py:deterministic_cuda). The options
not ported yet (--pred_program, --result_data, --output_dir, --id_list,
--sweep_steps, --no_loss, --unseen_test) are absent. Reading an HDF5
dataset needs h5py.
"""

from demo2program_tpu_torch.cli.flags import base_parser


def build_parser():
    p = base_parser()
    p.set_defaults(batch_size=20)
    p.add_argument("--dataset_split", type=str, default="test",
                   choices=["train", "test", "val"])
    p.add_argument("--train_dir", type=str, default="",
                   help="evaluate the newest checkpoint in this train_dir")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--max_steps", type=int, default=0,
                   help="number of batches; 0 = the whole split")
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
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    args.write_summary = not args.no_write_summary
    return args


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
    import torch

    from demo2program_tpu_torch.eval.evaler import Evaler
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, resolve_device)

    args = parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        deterministic_cuda()
    # results are compared with f32 references: no TF32 in convs or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    splits = read_splits(args, is_train=False)
    target = dict(zip(["train", "test", "val"], splits))[args.dataset_split]
    if not args.max_steps > 0:
        args.max_steps = len(target.ids) // args.batch_size
    Evaler(args, target, device=args.device).eval_run()


if __name__ == "__main__":
    main()
