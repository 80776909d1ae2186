"""Karel data and the program's entry objects, built as its CLIs build them.

The data comes from the program's own generator (the native engine), with
the configuration's sizes and a seed drawn from the run's seed: traffic,
not yardstick. Trainer and Evaler are built from trainer_cli's and
evaler_cli's parsers with the configuration's flags."""

from pathlib import Path

from bench_torch.harness.bench import ROOT

TRAIN_DIR = ROOT / "build" / "bench_torch" / "train_dir"


def make_split(cfg, programs, seed):
    """`programs` distinct programs from the generator, with k seen and
    test_k unseen demos each, padded to the configuration's T and L ->
    an in-memory split (ids, get_batch_compact)."""
    from demo2program_tpu_torch.data.karel_generator import (
        GeneratorConfig, generate_records)
    from demo2program_tpu_torch.data.karel_memory import split_from_records

    gen = GeneratorConfig(
        num_train=programs, num_test=0, num_val=0, seed=seed,
        max_program_length=cfg["max_program_len"],
        max_demo_length=cfg["max_demo_len"],
        num_demo_per_program=cfg["num_k"],
        num_test_demo_per_program=cfg["test_k"])
    records = generate_records(gen, "native", progress_every=0)
    return split_from_records(records, cfg["max_program_len"],
                              cfg["max_demo_len"])


def common_flags(cfg, device):
    return ["--model", cfg["model"], "--dataset_type", "karel",
            "--dataset_path", "in-memory", "--num_k", str(cfg["num_k"]),
            "--num_lstm_cell_units", str(cfg["num_lstm_cell_units"]),
            "--cell_impl", cfg["cell_impl"],
            "--compute_dtype", cfg["compute_dtype"],
            "--device", str(device)]


def make_trainer(cfg, ctx, split, log_step):
    """A Trainer on `split` (device cache on), its weights to be replaced
    by the caller; it writes nothing but an empty train dir."""
    from demo2program_tpu_torch.cli import trainer_cli
    from demo2program_tpu_torch.train.trainer import Trainer

    Path(TRAIN_DIR).mkdir(parents=True, exist_ok=True)
    argv = common_flags(cfg, ctx.device) + [
        "--batch_size", str(cfg["batch_size"]),
        "--learning_rate", str(cfg["learning_rate"]),
        "--seed", str(ctx.seed_for("program")),
        "--log_step", str(log_step), "--train_dir", str(TRAIN_DIR)]
    if cfg["lr_weight_decay"]:
        argv.append("--lr_weight_decay")
    args = trainer_cli.parse_args(argv)
    return Trainer(args, split, split, device=args.device)


def make_evaler(cfg, ctx, split, checkpoint):
    from demo2program_tpu_torch.cli import evaler_cli
    from demo2program_tpu_torch.eval.evaler import Evaler

    argv = common_flags(cfg, ctx.device) + [
        "--batch_size", str(cfg["eval_batch_size"]),
        "--checkpoint", str(checkpoint), "--quiet",
        "--unroll_type", cfg["unroll_type"]]
    args = evaler_cli.build_parser().parse_args(argv)
    return Evaler(args, split, device=args.device)
