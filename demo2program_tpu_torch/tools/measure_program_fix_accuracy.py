"""Edit-distance-tolerant accuracy sweep over a result.hdf5 dump.

The port's copy of demo2program_tpu/tools/measure_program_fix_accuracy.py
(`vizdoom_env/measure_program_fix_accuracy.py`): for every prediction,
computes the token-level edit distance to the ground truth and the
execution correctness on the unseen test demos, then reports, for
d = 0..19, the fraction of programs that are sequence-correct OR within edit
distance d, and execution-correct OR within d (`:84-90`). Used to estimate
how often predictions are "one edit away" from a working program.

    python -m demo2program_tpu_torch.tools.measure_program_fix_accuracy \
        --result_file train_dir/result.hdf5 \
        --data_file datasets/karel_dataset/data.hdf5 [--device cpu]

Works for both domains: Karel execution runs every program in one batched
call of the device VM (tools/eval_execution.py:batch_check on `--device`,
default cuda; without a card, cuda raises), ViZDoom execution replays the
engine on the host (eval/vizdoom_scorer.py). `--engine_config` defaults to
the packaged DoomLite config (the JAX tool's default names the reference
repository's asset). Reading the files needs h5py, imported in `main`: a
host without it raises ImportError there.
"""

import argparse

import numpy as np


def levenshtein(a, b):
    """Token-sequence edit distance."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def sweep(sequence_match, execute_correct, edit_distances, max_d=20):
    """-> list of (d, seq_acc, exe_acc) rows (`:84-90`)."""
    seqm = np.asarray(sequence_match, np.int32)
    exec_ = np.asarray(execute_correct, np.int32)
    dist = np.asarray(edit_distances, np.int32)
    rows = []
    for d in range(max_d):
        close = (dist <= d).astype(np.int32)
        rows.append((d,
                     float(np.clip(seqm + close, 0, 1).mean()),
                     float(np.clip(exec_ + close, 0, 1).mean())))
    return rows


def _decoded(result_file, did, vocab):
    """(program string, token ids, length) of the dump's prediction for
    `did`."""
    prog_len = int(result_file[did]["pred_program_len"][()])
    tokens = np.argmax(result_file[did]["pred_program"][()],
                       axis=0)[:prog_len]
    return vocab.intseq2str(tokens), tokens, prog_len


def _karel_execution(result_file, data_file, vocab, device):
    from demo2program_tpu_torch.tools.eval_execution import batch_check
    ids = [k for k in result_file.keys() if k != "data_info"]
    programs, demos, lens = [], [], []
    for did in ids:
        programs.append(_decoded(result_file, did, vocab)[0])
        demos.append(data_file[did]["test_s_h"][()])
        lens.append(data_file[did]["test_s_h_len"][()])
    outs = batch_check(programs, ids, demos, lens, vocab, device=device)
    k = demos[0].shape[0]
    return ids, programs, [o.num_correct == k for o in outs]


def _str(v):
    return v.decode() if isinstance(v, bytes) else str(v)


def _vizdoom_execution(result_file, data_file, engine_config):
    from demo2program_tpu_torch.dsl.vizdoom_vocab import VizDoomDSLVocab
    from demo2program_tpu_torch.eval.vizdoom_scorer import VizdoomScorer
    from demo2program_tpu_torch.models.common import ModelConfig
    info = data_file["data_info"]
    ptype = _str(info["perception_type"][()])
    vocab = VizDoomDSLVocab(perception_type=ptype)
    cfg = ModelConfig(
        dataset_type="vizdoom", perception_type=ptype,
        vizdoom_pos_keys=tuple(_str(k) for k in
                               info["vizdoom_pos_keys"][()]),
        h=int(info["s_h_h"][()]), w=int(info["s_h_w"][()]),
        depth=int(info["s_h_c"][()]),
        k=int(info["num_demo_per_program"][()]),
        test_k=int(info["num_test_demo_per_program"][()]))
    scorer = VizdoomScorer(cfg, vocab, engine_config=engine_config)
    ids = [k for k in result_file.keys() if k != "data_info"]
    programs, execute_correct = [], []
    for did in ids:
        program, tokens, prog_len = _decoded(result_file, did, vocab)
        programs.append(program)
        d = data_file[did]
        nc, _ = scorer.execution(
            tokens[None], np.array([prog_len]), np.zeros(1),
            d["test_s_h"][()][None], d["test_s_h_len"][()][None],
            d["test_vizdoom_init_pos"][()][None],
            d["test_vizdoom_init_pos_len"][()][None])
        execute_correct.append(nc[0] == cfg.test_k)
    return vocab, ids, programs, execute_correct


def main(argv=None):
    import h5py

    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--result_file", type=str, default="result.hdf5")
    p.add_argument("--data_file", type=str,
                   default="datasets/karel_dataset/data.hdf5")
    p.add_argument("--dataset_type", type=str, default="karel",
                   choices=["karel", "vizdoom"])
    p.add_argument("--engine_config", type=str, default=None,
                   help="DoomLite/ViZDoom config (default: the packaged "
                        "assets/doomlite.cfg)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"], help="of the Karel VM")
    args = p.parse_args(argv)

    from demo2program_tpu_torch.train.step import resolve_device

    with h5py.File(args.result_file, "r") as fr, \
            h5py.File(args.data_file, "r") as ft:
        if args.dataset_type == "karel":
            from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
            vocab = KarelVocab()
            ids, programs, execute_correct = _karel_execution(
                fr, ft, vocab, resolve_device(args.device))
        else:
            vocab, ids, programs, execute_correct = _vizdoom_execution(
                fr, ft, args.engine_config)
        seq_match, distances = [], []
        for did, prog in zip(ids, programs):
            gt = vocab.intseq2str(ft[did]["program"][()])
            seq_match.append(prog == gt)
            distances.append(levenshtein(prog.split(), gt.split()))

    rows = sweep(seq_match, execute_correct, distances)
    for d, seq_acc, exe_acc in rows:
        print(f"edit distance: {d}, seq_acc: {seq_acc}, exe_acc: {exe_acc}")
    return rows


if __name__ == "__main__":
    main()
