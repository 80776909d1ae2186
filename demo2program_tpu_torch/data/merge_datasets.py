"""Merge seed-sharded datasets (Karel or ViZDoom) into one.

    python -m demo2program_tpu_torch.data.merge_datasets \\
        datasets/shard_a datasets/shard_b --out_dir datasets/merged

Port of demo2program_tpu/data/merge_datasets.py (`vizdoom_env/
merge_datasets.py`): generation runs in parallel over seeds, and this
copies every shard's groups into one data.hdf5 with ids prefixed by the
shard's index (`<shard>_<id>`, in id.txt order), checking that the shards'
metadata agree. max_demo_length, max_program_length,
vizdoom_max_init_pos_len and the demo counts take the max across shards,
the split sizes add up, and percepts / vizdoom_pos_keys come from the first
shard that has them.

Beyond the JAX merge, which reads ViZDoom's keys from every shard: every
shard must hold the same data_info keys, a key of the lists below is merged
when the shards hold it (so Karel shards merge too), and `sprite_style` and
Karel's `dsl_type` are kept as consistent keys (the JAX merge drops them, so
a merged v3 ViZDoom dataset reads as v2 and a merged Karel dataset has no
dsl_type). h5py is imported inside `merge`.
"""

import argparse
import os

import numpy as np

from demo2program_tpu_torch.utils import log

_CONSISTENT_KEYS = ["num_program_tokens", "num_action_tokens",
                    "s_h_h", "s_h_w", "s_h_c", "perception_type",
                    "sprite_style", "dsl_type"]
# num_demo counts take the max across shards (`merge_datasets.py:61-63`)
_MAX_KEYS = ["max_demo_length", "max_program_length",
             "vizdoom_max_init_pos_len", "num_demo_per_program",
             "num_test_demo_per_program"]
_SUM_KEYS = ["num_train", "num_test", "num_val"]
_FIRST_KEYS = ["percepts", "vizdoom_pos_keys"]


def merge(shard_dirs, out_dir):
    import h5py

    os.makedirs(out_dir, exist_ok=True)
    meta = {}
    info_keys = None
    count = 0
    with h5py.File(os.path.join(out_dir, "data.hdf5"), "w") as out, \
            open(os.path.join(out_dir, "id.txt"), "w") as id_out:
        for shard_idx, shard in enumerate(shard_dirs):
            with h5py.File(os.path.join(shard, "data.hdf5"), "r") as f:
                info = f["data_info"]
                if info_keys is None:
                    info_keys = set(info.keys())
                elif set(info.keys()) != info_keys:
                    raise ValueError(
                        f"data_info keys of {shard} differ from the first "
                        f"shard's: {sorted(set(info.keys()) ^ info_keys)}")
                for key in _CONSISTENT_KEYS:
                    if key not in info:
                        continue
                    v = info[key][()]
                    if key in meta and not np.array_equal(meta[key], v):
                        raise ValueError(
                            f"inconsistent data_info[{key}] across shards: "
                            f"{meta[key]!r} vs {v!r} ({shard})")
                    meta.setdefault(key, v)
                for key in _MAX_KEYS:
                    if key in info:
                        meta[key] = max(meta.get(key, -1),
                                        int(info[key][()]))
                for key in _SUM_KEYS:
                    meta[key] = meta.get(key, 0) + int(info[key][()])
                for key in _FIRST_KEYS:
                    if key in info and key not in meta:
                        meta[key] = info[key][()]

                with open(os.path.join(shard, "id.txt")) as fp:
                    ids = [s.strip() for s in fp if s.strip()]
                for old_id in ids:
                    # shard-index prefix, as the reference does
                    # (`merge_datasets.py:95-96`)
                    new_id = f"{shard_idx}_{old_id}"
                    f.copy(f[old_id], out, name=new_id)
                    id_out.write(new_id + "\n")
                    count += 1
            log.info("merged %s (%d ids so far)", shard, count)

        grp = out.create_group("data_info")
        for key, v in meta.items():
            grp[key] = v
    log.info("merged %d shards -> %s (%d examples)", len(shard_dirs),
             out_dir, count)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("shards", nargs="+")
    p.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    merge(args.shards, args.out_dir)


if __name__ == "__main__":
    main()
