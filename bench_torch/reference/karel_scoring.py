"""Plain scoring of decoded Karel programs, on the host: syntax, exact
program (canonical form) and execution on every demo, with the
benchmark's frozen copy of the DSL's parser, canonical form and
interpreter.

Execution is correct on a demo iff the program, run from the demo's
initial state with errors raised (a blocked move, a marker missing or
overflowing), succeeds within the call budget and its states equal the
demo's recorded ones, length included; a program whose tokens equal the
ground truth's is correct by definition."""

import numpy as np

from bench_torch.reference.karel_dsl import (
    karel_canonical, karel_interp, karel_parser)
from bench_torch.reference.karel_dsl.karel_vocab import KarelVocab
from bench_torch.reference.karel_dsl.karel_world import (
    KarelWorld, batch_to_states)

VOCAB = KarelVocab()


def _demos(compact, prefix):
    """-> ([per example, per demo: (initial state, recorded states)])."""
    wall = compact[prefix + "c_wall"]
    bs, k, h, w = wall.shape
    init = batch_to_states(
        wall.reshape(bs * k, h, w).astype(bool),
        compact[prefix + "c_marker"].reshape(bs * k, h, w),
        compact[prefix + "c_agent"].reshape(bs * k, 3).astype(np.int64))
    acts = compact[prefix + "c_a_raw"].astype(np.int64)
    dl = compact[prefix + "demo_len"].astype(np.int64)
    out = []
    for b in range(bs):
        row = []
        for j in range(k):
            world = KarelWorld(init[b * k + j], make_error=False)
            for a in acts[b, j, :dl[b, j] - 1]:
                world.state_transition(int(a))
            row.append((init[b * k + j], world.s_h))
        out.append(row)
    return out


def _runs(ast, initial, recorded):
    world = KarelWorld(initial, make_error=True)
    _, ok = karel_interp.execute(ast, world)
    return bool(ok and len(world.s_h) == len(recorded) and all(
        np.array_equal(a, b) for a, b in zip(world.s_h, recorded)))


def score(compact, served, served_len):
    """A compact batch and the decoded tokens (bs, L), lengths (bs,) ->
    dict of syntax (bs,), exact (bs,), seen (bs, k) per-demo verdicts and
    unseen (bs,) counts of correct unseen demos."""
    gt = compact["program_tokens"]
    gt_len = compact["program_len"][:, 0].astype(np.int64)
    seen, unseen = _demos(compact, ""), _demos(compact, "test_")
    bs = gt.shape[0]
    out = {"syntax": np.zeros(bs), "exact": np.zeros(bs),
           "seen": np.zeros((bs, len(seen[0])), bool),
           "unseen": np.zeros(bs)}
    for i in range(bs):
        n = int(served_len[i])
        pred = [int(t) for t in served[i, :n]]
        truth = [int(t) for t in gt[i, :gt_len[i]]]
        same = pred == truth
        p_str, g_str = VOCAB.intseq2str(pred), VOCAB.intseq2str(truth)
        ast, ok = karel_parser.parse(p_str)
        syntax = same or ok
        out["syntax"][i] = syntax
        out["exact"][i] = syntax and karel_canonical.programs_equal(
            p_str, g_str)
        for j, (initial, recorded) in enumerate(seen[i]):
            out["seen"][i, j] = same or (ok and _runs(ast, initial, recorded))
        out["unseen"][i] = sum(same or (ok and _runs(ast, a, b))
                               for a, b in unseen[i])
    return out
