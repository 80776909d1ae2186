"""Shared argparse flags with reference-CLI parity (`trainer.py:243-291`,
`evaler.py:362-425`).

The port's own copy of demo2program_tpu/cli/flags.py: the same flags with
the same defaults, so one argv parses to the same namespace in both
packages. The help texts say what each flag does in the port."""

import argparse


def base_parser():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--prefix", type=str, default="default")
    p.add_argument("--model", type=str, default="full",
                   choices=["synthesis_baseline", "induction_baseline",
                            "summarizer", "full"])
    p.add_argument("--dataset_type", type=str, default="karel",
                   choices=["karel", "vizdoom"])
    p.add_argument("--dataset_path", type=str,
                   default="datasets/karel_dataset")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--num_k", type=int, default=10,
                   help="number of seen demonstrations")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seed", type=int, default=123)
    # model hyperparameters
    p.add_argument("--encoder_rnn_type", default="lstm",
                   choices=["lstm", "bilstm"])
    p.add_argument("--num_lstm_cell_units", type=int, default=512)
    p.add_argument("--demo_aggregation", type=str, default="avgpool",
                   choices=["concat", "avgpool", "maxpool"])
    p.add_argument("--cell_impl", type=str, default="xla",
                   choices=["xla", "pallas", "pallas_jnp"],
                   help="LSTM parameter layout of the JAX package's cell "
                        "(models/convert.py reads it); every value runs the "
                        "fused CUDA kernel here (ops/fused_lstm.py)")
    p.add_argument("--scheduled_sampling", action="store_true",
                   default=False)
    p.add_argument("--scheduled_sampling_decay_steps", type=int,
                   default=20000)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="forward/backward compute dtype; with bfloat16 "
                        "the parameters, Adam's state, the loss, the BN "
                        "running statistics and the checkpoints stay "
                        "float32")
    return p


def add_train_flags(p):
    p.add_argument("--train_dir", type=str, default=None)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--lr_weight_decay", action="store_true", default=False)
    p.add_argument("--log_step", type=int, default=10)
    p.add_argument("--write_summary_step", type=int, default=100)
    p.add_argument("--test_sample_step", type=int, default=100)
    p.add_argument("--ckpt_save_step", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=1_000_000)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace (the host, and the "
                        "card's kernels on cuda) of N steps from "
                        "--profile_start, written as a Chrome trace to "
                        "<train_dir>/profile; the program's d2p.* spans "
                        "are on for those steps, appear in the trace as "
                        "ranges, and their summary (calls, inclusive and "
                        "self ms a step) is logged at the end")
    p.add_argument("--profile_start", type=int, default=10)
    p.add_argument("--sample_images", action="store_true", default=False,
                   help="also write PNGs per test-sample step to "
                        "<train_dir>/samples: the gt / pred / greedy "
                        "programs' heat map, and on Karel the first demo's "
                        "states, action map and perception map, mirroring "
                        "the reference's image summaries "
                        "(model_full.py:1223-1297)")
    return p
