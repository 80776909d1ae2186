"""Training entry point of the port: the model families `--model full |
synthesis_baseline | summarizer | induction_baseline` (default full) on
`--dataset_type karel | vizdoom`.

    python -m demo2program_tpu_torch.cli.trainer_cli \
        --dataset_path datasets/karel_dataset --num_k 10 --device cuda \
        --model summarizer

Flags follow demo2program_tpu/cli/trainer_cli.py (the shared
cli/flags.py parsers, the port's copy), plus `--device {cuda,cpu}` (default
cuda; without a card, cuda raises). On the card, kernels run in
deterministic mode (train/step.py:deterministic_cuda, before any CUDA work),
so a resumed run repeats the uninterrupted one bit for bit. Relaunching a
finished stage logs "Nothing to do" before loading any data. Reading an
HDF5 dataset needs h5py; train/trainer.py:Trainer also takes the in-memory
splits of data/karel_memory.py and data/vizdoom_memory.py.

Data parallelism over N processes, `--batch_size` being the global batch:

    torchrun --nproc_per_node N -m demo2program_tpu_torch.cli.trainer_cli \
        --device cuda ...

Each rank runs on cuda:LOCAL_RANK over NCCL (one card a rank), or with
`--device cpu` on the CPU over gloo. Without torchrun's variables the run is
one process with no process group.
"""

import json
import os

from demo2program_tpu_torch.cli.flags import add_train_flags, base_parser
from demo2program_tpu_torch.utils import log
from demo2program_tpu_torch.train.checkpoint import checkpoint_steps


def build_parser():
    p = add_train_flags(base_parser())
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def _stage_already_done(train_dir):
    """True when `train_dir` holds a checkpoint at (or past) the target
    recorded in its resume.json."""
    resume = os.path.join(train_dir or "", "resume.json")
    if not (train_dir and os.path.exists(resume)):
        return False
    try:
        with open(resume) as f:
            target = int(json.load(f)["target_step"])
    except (ValueError, KeyError, OSError):
        return False
    steps = checkpoint_steps(train_dir)
    return bool(steps) and steps[-1] >= target


def main(argv=None):
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, full_precision_matmuls, resolve_device)

    args = parse_args(argv)
    if resolve_device(args.device).type == "cuda":
        deterministic_cuda()
    if _stage_already_done(args.train_dir):
        log.infov("Nothing to do: %s already reached its resume.json "
                  "target", args.train_dir)
        return
    # no TF32, and bf16 GEMMs that reduce in f32
    full_precision_matmuls()

    from demo2program_tpu_torch.cli.evaler_cli import read_splits
    from demo2program_tpu_torch.train.trainer import Trainer

    import torch.distributed as dist

    ds_train, ds_test, _ = read_splits(args, is_train=True)
    try:
        trainer = Trainer(args, ds_train, ds_test, device=args.device)
        log.warning("dataset: %s, learning_rate: %f", args.dataset_path,
                    args.learning_rate)
        trainer.train(max_steps=args.max_steps)
    finally:
        if dist.is_initialized():  # the group the trainer's mesh formed
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
