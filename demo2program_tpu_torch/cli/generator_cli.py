"""Karel dataset generation entry point of the port.

    python -m demo2program_tpu_torch.cli.generator_cli \\
        --dir_name karel_dataset --num_train 100 --num_test 20 --num_val 20 \\
        --backend native

Port of demo2program_tpu/cli/generator_cli.py, flag for flag
(`karel_env/generator.py:169-199`; the reference's three scripts are one
pass). The dataset goes to <datasets_root>/<dir_name>: data.hdf5 and
id.txt, the same as the JAX generator writes for a seed and backend.
`--backend auto` takes the native C++ engine when g++ builds it and logs
which backend it took; `native` raises when the build fails. Writing needs
h5py; a host without it makes its split in memory
(data/karel_generator.py:generate_records).
"""

import argparse
import os

from demo2program_tpu_torch.data.karel_generator import (
    GeneratorConfig, generate)


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dir_name", type=str, default="karel_dataset")
    p.add_argument("--height", type=int, default=8)
    p.add_argument("--width", type=int, default=8)
    p.add_argument("--num_train", type=int, default=25000)
    p.add_argument("--num_test", type=int, default=5000)
    p.add_argument("--num_val", type=int, default=5000)
    p.add_argument("--wall_prob", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--max_program_length", type=int, default=50)
    p.add_argument("--max_program_stmt_depth", type=int, default=6)
    p.add_argument("--max_program_nesting_depth", type=int, default=4)
    p.add_argument("--min_max_demo_length_for_program", type=int, default=2)
    p.add_argument("--min_demo_length", type=int, default=8)
    p.add_argument("--max_demo_length", type=int, default=20)
    p.add_argument("--num_demo_per_program", type=int, default=10)
    p.add_argument("--num_test_demo_per_program", type=int, default=5)
    p.add_argument("--max_demo_generation_trial", type=int, default=100)
    p.add_argument("--datasets_root", type=str, default="datasets")
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "native", "python"],
                   help="demo rollout executor; 'native' is the C++ batch "
                        "engine (both produce identical datasets)")
    args = p.parse_args(argv)

    dir_name = os.path.join(args.datasets_root, args.dir_name)
    cfg = GeneratorConfig(
        dir_name=dir_name, height=args.height, width=args.width,
        num_train=args.num_train, num_test=args.num_test,
        num_val=args.num_val, wall_prob=args.wall_prob, seed=args.seed,
        max_program_length=args.max_program_length,
        max_program_stmt_depth=args.max_program_stmt_depth,
        max_program_nesting_depth=args.max_program_nesting_depth,
        min_max_demo_length_for_program=args.min_max_demo_length_for_program,
        min_demo_length=args.min_demo_length,
        max_demo_length=args.max_demo_length,
        num_demo_per_program=args.num_demo_per_program,
        num_test_demo_per_program=args.num_test_demo_per_program,
        max_demo_generation_trial=args.max_demo_generation_trial)
    generate(cfg, backend=args.backend)


if __name__ == "__main__":
    main()
