"""ASCII viewer of a Karel dataset's stored demos.

    python -m demo2program_tpu_torch.tools.visualize_data \\
        --dataset_path datasets/karel_dataset --no_input

Port of demo2program_tpu/tools/visualize_data.py (`karel_env/tool/
visualize_data.py`): steps through the demonstrations of a dataset entry,
rendering each Karel state and the action taken. `--no_input` prints the
first entry (or `--id`) at once, for piped output. h5py is imported where
the file is opened.
"""

import argparse
import os

from demo2program_tpu_torch.dsl.karel_vocab import (
    ENV_ACTION_TO_TOKEN, KarelVocab)
from demo2program_tpu_torch.tools.karel_render import state2str


def show_entry(f, data_id, vocab, interactive=True, max_demos=None):
    grp = f[data_id]
    code = vocab.intseq2str(grp["program"][()])
    print(f"\n[id: {data_id}]\nprogram: {code}")
    s_h = grp["s_h"][()]
    s_h_len = grp["s_h_len"][()]
    a_h = grp["a_h"][()]
    n = s_h.shape[0] if max_demos is None else min(max_demos, s_h.shape[0])
    for k in range(n):
        print(f"\n-- demo {k} (len {int(s_h_len[k])}) --")
        for t in range(int(s_h_len[k])):
            if t > 0:
                act = ENV_ACTION_TO_TOKEN[int(a_h[k, t - 1])]
                print(f"step {t}: {act}")
            else:
                print("initial state:")
            print(state2str(s_h[k, t]))
            if interactive:
                cmd = input("[enter: next state, d: next demo, q: quit] ")
                if cmd.strip() == "q":
                    return False
                if cmd.strip() == "d":
                    break
    return True


def main(argv=None):
    import h5py

    p = argparse.ArgumentParser()
    p.add_argument("--dataset_path", type=str,
                   default="datasets/karel_dataset")
    p.add_argument("--id", type=str, default=None,
                   help="specific entry id; default iterates id.txt order")
    p.add_argument("--no_input", action="store_true", default=False)
    p.add_argument("--max_demos", type=int, default=None)
    args = p.parse_args(argv)

    vocab = KarelVocab()
    with h5py.File(os.path.join(args.dataset_path, "data.hdf5"), "r") as f:
        if args.id:
            show_entry(f, args.id, vocab, not args.no_input, args.max_demos)
            return
        with open(os.path.join(args.dataset_path, "id.txt")) as fp:
            ids = [s.strip() for s in fp if s.strip()]
        for data_id in ids:
            if not show_entry(f, data_id, vocab, not args.no_input,
                              args.max_demos):
                break
            if args.no_input:
                break  # one entry in non-interactive mode


if __name__ == "__main__":
    main()
