"""Prediction browser over the evaler's `out_*.hdf5` dumps.

Port of demo2program_tpu/tools/inspect_output.py
(`karel_env/tool/inspect_output.py`): joins a dump with the dataset and
shows the ground-truth and the predicted programs with their syntax and
execution verdicts; `--replay` runs the decoded program from the first
demo's initial state and prints the rollout in ASCII; `--no_input` prints
every example without waiting for a key. Runs on the host (the interpreter
of dsl/karel_interp.py): it needs no device. h5py is imported in `main`.
"""

import argparse

from demo2program_tpu_torch.dsl import karel_interp, karel_parser
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.envs.karel import KarelWorld
from demo2program_tpu_torch.tools.karel_render import state2str


def _dec(v):
    return v.decode() if isinstance(v, bytes) else str(v)


def show_prediction(data, out, data_id, vocab, replay=False):
    gt = vocab.intseq2str(data[data_id]["program"][()])
    o = out[data_id]
    print(f"\n[id: {data_id}]")
    print(f"gt:     {gt}")
    print(f"pred:   {_dec(o['program_prediction'][()])} "
          f"(syntax {_dec(o['program_syntax'][()])}, "
          f"exec {int(o['program_num_execution_correct'][()])} correct)")
    print(f"greedy: {_dec(o['greedy_prediction'][()])} "
          f"(syntax {_dec(o['greedy_syntax'][()])}, "
          f"exec {int(o['greedy_num_execution_correct'][()])} correct)")
    if replay:
        code = _dec(o["greedy_prediction"][()])
        ast, ok = karel_parser.parse(code)
        if not ok:
            print("greedy prediction does not parse; cannot replay")
            return
        s0 = data[data_id]["s_h"][()][0, 0]
        world = KarelWorld(s0.copy())
        _, success = karel_interp.execute(ast, world)
        print(f"replay on demo 0 initial state (success={success}):")
        for t, s in enumerate(world.s_h):
            print(f"step {t}:")
            print(state2str(s))


def main(argv=None):
    import h5py

    p = argparse.ArgumentParser()
    p.add_argument("--data_hdf5", required=True)
    p.add_argument("--output_hdf5", required=True)
    p.add_argument("--id", type=str, default=None)
    p.add_argument("--replay", action="store_true", default=False)
    p.add_argument("--no_input", action="store_true", default=False)
    args = p.parse_args(argv)

    vocab = KarelVocab()
    with h5py.File(args.data_hdf5, "r") as data, \
            h5py.File(args.output_hdf5, "r") as out:
        ids = [args.id] if args.id else \
            [k for k in out.keys() if k != "data_info"]
        for data_id in ids:
            show_prediction(data, out, data_id, vocab, replay=args.replay)
            if args.no_input:
                continue
            if input("[enter: next, q: quit] ").strip() == "q":
                break


if __name__ == "__main__":
    main()
