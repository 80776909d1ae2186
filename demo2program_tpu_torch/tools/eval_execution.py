"""Offline re-scoring of dumped program predictions.

Port of demo2program_tpu/tools/eval_execution.py
(`karel_env/tool/eval_execution.py`): takes the dataset's data.hdf5 and an
evaler `out_*.hdf5` dump (`evaler_cli --pred_program`), re-executes the
teacher-forced and the decoded predictions against the seen (train) and
unseen (test) demos, and prints syntax accuracy, the execution-accuracy
histograms and the 100%-correct rates; `--log` writes that report to a file
and `--dump` a merged result HDF5.

    python -m demo2program_tpu_torch.tools.eval_execution \
        --data_hdf5 datasets/karel_dataset/data.hdf5 \
        --output_hdf5 train_dir/out_20000_test.hdf5 [--device cpu]

All rollouts of a result table run as one batched call of the device VM
(ops/vm.py) on `--device` (default cuda; without a card, cuda raises).
`batch_check` takes numpy demos, so it also re-scores programs that never
went through a file. h5py is imported in `main`, where the files are
opened.
"""

import argparse
import collections

import numpy as np
import torch

from demo2program_tpu_torch.dsl.karel_bytecode import (
    DEFAULT_MAX_CODE_LEN, compile_tokens)
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.ops import vm
from demo2program_tpu_torch.ops.grids import decode_states
from demo2program_tpu_torch.train.step import resolve_device

CheckProgramOutput = collections.namedtuple(
    "CheckProgramOutput",
    ("data_id", "program", "syntax", "num_correct", "demo_correctness"))

RESULT_NAMES = ("train_tf_result", "test_tf_result", "train_greedy_result",
                "test_greedy_result")


class EvaluationResult:
    """Accumulates CheckProgramOutputs; the summary of
    `tool/eval_execution.py:70-120`."""

    def __init__(self, name):
        self.name = name
        self.outputs = {}

    def add(self, out):
        self.outputs[out.data_id] = out

    def result_string(self):
        outs = list(self.outputs.values())
        n = len(outs)
        syntax_acc = np.mean([o.syntax for o in outs]) if n else 0.0
        num_demo = max((len(o.demo_correctness) for o in outs), default=0)
        hist = np.zeros(num_demo + 1)
        for o in outs:
            hist[int(o.num_correct)] += 1
        hist = hist / max(n, 1)
        all_correct = float(hist[-1]) if num_demo else 0.0
        hist_str = ", ".join(f"{v:.3f}" for v in hist)
        return ("[{name}] n: {n}, syntax_acc: {syntax: .3f}, "
                "100%-exec-correct: {allc: .3f}\n"
                "  #correct-of-k histogram: [{hist}]\n").format(
            name=self.name, n=n, syntax=syntax_acc, allc=all_correct,
            hist=hist_str)

    def get(self, data_id):
        return self.outputs[data_id]


def batch_check(programs, data_ids, demos, demo_lens, vocab, make_error=True,
                device="cuda"):
    """Re-execute the program string `programs[i]` against the demos
    `demos[i]` (k, T, h, w, 16) of lengths `demo_lens[i]` (k,) on `device`
    -> a list of CheckProgramOutput. A program that does not tokenize or
    compile has syntax False and no demo correct. The time axis is as long
    as the longest demo given; `demo_lens` mask the rest."""
    device = resolve_device(device)
    n = len(programs)
    k = demos[0].shape[0]
    h, w = demos[0].shape[2], demos[0].shape[3]
    T = max(d.shape[1] for d in demos)

    codes = np.zeros([n, DEFAULT_MAX_CODE_LEN, 2], np.int32)
    ok = np.zeros(n, bool)
    for i, prog in enumerate(programs):
        ids = vocab.str2intseq(prog) if all(
            t in vocab.token2int for t in prog.split()) else []
        codes[i], ok[i] = (compile_tokens(ids, vocab)
                           if ids else (codes[i], False))

    demo_np = np.zeros([n, k, T, h, w, demos[0].shape[-1]], np.uint8)
    lens = np.ones([n, k], np.int32)
    for i, d in enumerate(demos):
        demo_np[i, :, :d.shape[1]] = d
        lens[i] = demo_lens[i]

    dec = decode_states(torch.from_numpy(demo_np).to(device))

    def flat(a):
        return a.reshape((n * k,) + tuple(a.shape[2:]))

    out = vm.run_and_compare(
        torch.from_numpy(np.repeat(codes, k, axis=0)).to(device),
        flat(dec["wall"][:, :, 0]), flat(dec["y"][:, :, 0]),
        flat(dec["x"][:, :, 0]), flat(dec["d"][:, :, 0]),
        flat(dec["markers"][:, :, 0]),
        flat(dec["y"]), flat(dec["x"]), flat(dec["d"]),
        flat(dec["markers"]),
        torch.from_numpy(lens.reshape(-1)).to(device),
        make_error=make_error, h=h, w=w)
    correct = out["correct"].cpu().numpy().reshape(n, k) & ok[:, None]
    return [CheckProgramOutput(data_ids[i], programs[i], bool(ok[i]),
                               int(correct[i].sum()), correct[i])
            for i in range(n)]


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_hdf5", required=True)
    p.add_argument("--output_hdf5", required=True)
    p.add_argument("--log", action="store_true", default=False)
    p.add_argument("--output_log_path", type=str, default=None)
    p.add_argument("--dump", action="store_true", default=False)
    p.add_argument("--new_hdf5_path", type=str, default=None)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def main(argv=None):
    import h5py

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    vocab = KarelVocab()
    results = {name: EvaluationResult(name) for name in RESULT_NAMES}

    with h5py.File(args.data_hdf5, "r") as fd, \
            h5py.File(args.output_hdf5, "r") as fo:
        ids = [k for k in fo.keys() if k != "data_info"]
        for lo in range(0, len(ids), args.batch):
            chunk = ids[lo:lo + args.batch]
            tf_progs, greedy_progs = [], []
            train_demos, train_lens, test_demos, test_lens = [], [], [], []
            for did in chunk:
                out = fo[did]
                data = fd[did]
                tf_progs.append(_dec(out["program_prediction"][()]))
                greedy_progs.append(_dec(out["greedy_prediction"][()]))
                train_demos.append(data["s_h"][()])
                train_lens.append(data["s_h_len"][()])
                test_demos.append(data["test_s_h"][()])
                test_lens.append(data["test_s_h_len"][()])
            for name, progs, demos, lens in [
                    ("train_tf_result", tf_progs, train_demos, train_lens),
                    ("test_tf_result", tf_progs, test_demos, test_lens),
                    ("train_greedy_result", greedy_progs, train_demos,
                     train_lens),
                    ("test_greedy_result", greedy_progs, test_demos,
                     test_lens)]:
                for out in batch_check(progs, chunk, demos, lens, vocab,
                                       device=device):
                    results[name].add(out)

    report = ""
    for r in results.values():
        report += r.result_string()
    print(report)
    if args.log:
        path = args.output_log_path or f"{args.output_hdf5}.eval_exe.log"
        with open(path, "w") as f:
            f.write(report)
    if args.dump:
        path = args.new_hdf5_path or f"{args.output_hdf5}.eval_exe.hdf5"
        correctness = ["wrong", "correct"]
        with h5py.File(path, "w") as nf:
            for did in results["train_tf_result"].outputs:
                grp = nf.create_group(did)
                for prefix, tr, te in [
                        ("program", results["train_tf_result"],
                         results["test_tf_result"]),
                        ("greedy", results["train_greedy_result"],
                         results["test_greedy_result"])]:
                    o, ot = tr.get(did), te.get(did)
                    pred_key = ("program_prediction" if prefix == "program"
                                else "greedy_prediction")
                    grp[pred_key] = o.program
                    grp[f"{prefix}_syntax"] = correctness[int(o.syntax)]
                    grp[f"{prefix}_is_correct_execution"] = \
                        o.demo_correctness
                    grp[f"{prefix}_num_execution_correct"] = o.num_correct
                    grp[f"test_{pred_key}"] = ot.program
                    grp[f"test_{prefix}_syntax"] = correctness[int(ot.syntax)]
                    grp[f"test_{prefix}_is_correct_execution"] = \
                        ot.demo_correctness
                    grp[f"test_{prefix}_num_execution_correct"] = \
                        ot.num_correct
        print(f"Dumped result file: {path}")


def _dec(v):
    return v.decode() if isinstance(v, bytes) else str(v)


if __name__ == "__main__":
    main()
