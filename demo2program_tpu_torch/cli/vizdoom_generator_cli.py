"""ViZDoom dataset generation entry point of the port.

    python -m demo2program_tpu_torch.cli.vizdoom_generator_cli \\
        --dir_name vizdoom_dataset --num_train 100 --num_test 20

Port of demo2program_tpu/cli/vizdoom_generator_cli.py, flag for flag
(`vizdoom_env/generator.py:300-323`, + the if-else dataset variant via
--ifelse). The dataset goes to <datasets_root>/<dir_name>_len
{max_demo_length}_seed{seed}, written by data/vizdoom_generator.py: the
same data.hdf5 and id.txt as the JAX generator's for a seed. The engine is
DoomLite unless the `vizdoom` package is installed. Writing needs h5py; a
host without it makes its split in memory (data/vizdoom_memory.py).
"""

import argparse
import os

from demo2program_tpu_torch.data.vizdoom_generator import (
    VizdoomGeneratorConfig, generate)


def main(argv=None):
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--dir_name", type=str, default="vizdoom_dataset")
    p.add_argument("--num_train", type=int, default=10000)
    p.add_argument("--num_test", type=int, default=1000)
    p.add_argument("--num_val", type=int, default=100)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--max_program_length", type=int, default=32)
    p.add_argument("--min_demo_length", type=int, default=2)
    p.add_argument("--max_demo_length", type=int, default=8)
    p.add_argument("--num_demo_per_program", type=int, default=40)
    p.add_argument("--num_test_demo_per_program", type=int, default=10)
    p.add_argument("--width", type=int, default=80)
    p.add_argument("--height", type=int, default=80)
    p.add_argument("--perception_type", type=str, default="simple")
    p.add_argument("--sprite_style", type=str, default="v2",
                   choices=["v2", "v3"],
                   help="DoomLite sprite style; v3 adds species-"
                        "unique silhouette carving")
    p.add_argument("--ifelse", action="store_true", default=False,
                   help="generate the single-IFELSE dataset variant")
    p.add_argument("--engine_config", type=str,
                   default="vizdoom_env/asset/default.cfg")
    p.add_argument("--datasets_root", type=str, default="datasets")
    args = p.parse_args(argv)

    dir_name = "{}_len{}_seed{}".format(
        args.dir_name, args.max_demo_length, args.seed)
    cfg = VizdoomGeneratorConfig(
        dir_name=os.path.join(args.datasets_root, dir_name),
        engine_config=args.engine_config,
        num_train=args.num_train, num_test=args.num_test,
        num_val=args.num_val, seed=args.seed,
        max_program_length=args.max_program_length,
        min_demo_length=args.min_demo_length,
        max_demo_length=args.max_demo_length,
        num_demo_per_program=args.num_demo_per_program,
        num_test_demo_per_program=args.num_test_demo_per_program,
        width=args.width, height=args.height,
        perception_type=args.perception_type,
        sprite_style=args.sprite_style,
        ifelse=args.ifelse)
    generate(cfg)


if __name__ == "__main__":
    main()
