"""Program scoring: syntax, canonical-program equality, execution accuracy.

Port of demo2program_tpu/eval/scorer.py (`model_full.py:602-916`):

  * is_correct_syntax = 1 if the predicted sequence matches the ground
    truth exactly, else whether the prefix up to the predicted length
    parses;
  * exact-program accuracy: canonical-form equality, gated on syntax;
  * execution: each predicted program replays every demo's initial state
    on the device VM (ops/vm.py); correct iff the whole state sequence and
    its length match, OR the tokens matched exactly.

Syntax and canonical checks are host string work on the shared DSL; the
(bs x k) execution grid runs on the device. `timings` holds the seconds
spent in each, the process's totals of the spans (utils/spans.py) that
time them: "host", `d2p.score.host` (parsing, canonical forms and bytecode
compilation); "vm", `d2p.score.replay` (the demos' replay) and
`d2p.score.vm` (the VM runs, synchronised by the copy of the verdicts to
the host).
"""

import numpy as np
import torch

from demo2program_tpu_torch.dsl import karel_canonical, karel_parser
from demo2program_tpu_torch.dsl.karel_bytecode import (
    DEFAULT_MAX_CODE_LEN, compile_batch)
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.ops import reconstruct, vm
from demo2program_tpu_torch.ops.grids import decode_states
from demo2program_tpu_torch.utils import spans

TIMINGS = {"host": ("d2p.score.host",),
           "vm": ("d2p.score.replay", "d2p.score.vm")}


def to_host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class KarelScorer:
    def __init__(self, cfg, device, vocab=None,
                 max_code_len=DEFAULT_MAX_CODE_LEN):
        self.cfg = cfg
        self.device = torch.device(device)
        self.vocab = vocab or KarelVocab()
        self.max_code_len = max_code_len
        self.make_error = cfg.env_type != "no_error"
        self.timings = spans.TotalsView(**TIMINGS)

    # -- host-side string metrics --------------------------------------------
    def syntax_and_exact(self, pred_tokens, pred_len, is_same_seq,
                         gt_tokens, gt_len):
        """Returns (is_correct_syntax (bs,), exact_correct (bs,))."""
        with spans.span("d2p.score.host"):
            bs = pred_tokens.shape[0]
            syntax = np.zeros(bs, np.float32)
            exact = np.zeros(bs, np.float32)
            for i in range(bs):
                p_str = self.vocab.intseq2str(
                    pred_tokens[i, :int(pred_len[i])])
                if is_same_seq[i] == 1:
                    syntax[i] = 1.0
                else:
                    _, ok = karel_parser.parse(p_str)
                    syntax[i] = float(ok)
                if syntax[i] == 1.0:
                    g_str = self.vocab.intseq2str(
                        gt_tokens[i, :int(gt_len[i])])
                    exact[i] = float(
                        karel_canonical.programs_equal(p_str, g_str))
        return syntax, exact

    # -- on-device execution accuracy ----------------------------------------
    def execution(self, pred_tokens, pred_len, is_same_seq, s_h, demo_len):
        """Execution correctness against full (bs, k, T, h, w, 16) demo
        tensors. Returns (num_correct (bs,), is_correct (bs, k))."""
        s_h = torch.as_tensor(s_h, device=self.device)
        bs, k = s_h.shape[0], s_h.shape[1]
        dec = decode_states(s_h)

        def flat(a):
            return a.reshape((bs * k,) + tuple(a.shape[2:]))

        target = {"wall": flat(dec["wall"][:, :, 0]), "y": flat(dec["y"]),
                  "x": flat(dec["x"]), "d": flat(dec["d"]),
                  "markers": flat(dec["markers"])}
        init = (flat(dec["y"][:, :, 0]), flat(dec["x"][:, :, 0]),
                flat(dec["d"][:, :, 0]), flat(dec["markers"][:, :, 0]))
        return self._execute_against(pred_tokens, pred_len, is_same_seq,
                                     target, init, demo_len, bs, k)

    def execution_compact(self, pred_tokens, pred_len, is_same_seq, batch,
                          test=False):
        """Execution correctness against a COMPACT batch (tensors on the
        scorer's device): the target state sequences are replayed on the
        device from initial state + recorded actions."""
        pfx = "test_" if test else ""
        with spans.span("d2p.score.replay"):
            rep, bs, k = (reconstruct.replay_test(batch, self.cfg) if test
                          else reconstruct.replay_seen(batch, self.cfg))
        init = (rep["y"][:, 0], rep["x"][:, 0], rep["d"][:, 0],
                rep["markers"][:, 0])
        return self._execute_against(
            pred_tokens, pred_len, is_same_seq, rep, init,
            batch[pfx + "demo_len"], bs, k)

    def _execute_against(self, pred_tokens, pred_len, is_same_seq, target,
                         init, demo_len, bs, k):
        with spans.span("d2p.score.host"):
            codes, compiled_ok = compile_batch(
                to_host(pred_tokens), to_host(pred_len), self.vocab,
                self.max_code_len)
            codes_rep = np.repeat(codes, k, axis=0)  # one program per demo
        with spans.span("d2p.score.vm"):
            out = vm.run_and_compare(
                torch.as_tensor(codes_rep, device=self.device),
                target["wall"], init[0], init[1], init[2], init[3],
                target["y"], target["x"], target["d"], target["markers"],
                torch.as_tensor(demo_len, device=self.device).reshape(
                    bs * k),
                make_error=self.make_error, h=self.cfg.h, w=self.cfg.w)
            vm_correct = out["correct"].cpu().numpy().reshape(bs, k)

        same = to_host(is_same_seq).astype(bool)[:, None]
        ok = compiled_ok[:, None]
        # execute only when syntactically valid and not an exact token
        # match; exact matches are correct by definition
        is_correct = (vm_correct & ok & ~same) | same
        return is_correct.sum(axis=1).astype(np.float32), is_correct

    def execution_histogram(self, num_correct, k):
        hist = np.zeros(k + 1, np.float32)
        for i in range(k + 1):
            hist[i] = float((num_correct == i).sum()) / len(num_correct)
        return hist

    def rerank_pick(self, beam_tokens, beam_lens, batch):
        """Execution-guided beam selection (demo2program_tpu/eval/
        scorer.py:137-152): per example, the first beam (beams arrive
        sorted by score) whose program reproduces ALL seen demos, the
        model's own inputs, else beam 0. One batched VM call per beam.
        beam_tokens (bs, K, L), beam_lens (bs, K) -> pick (bs,) int."""
        bs, K, _ = beam_tokens.shape
        all_ok = np.zeros((bs, K), bool)
        no_shortcut = np.zeros(bs, np.float32)
        for j in range(K):
            nc, _ = self.execution_compact(
                beam_tokens[:, j], beam_lens[:, j], no_shortcut, batch)
            all_ok[:, j] = nc == self.cfg.k
        return np.where(all_ok.any(axis=1), all_ok.argmax(axis=1), 0)

    def score_batch(self, batch, evals):
        """Full scoring of one compact eval batch (tensors on the scorer's
        device) for the teacher-forced and the greedy predictions. `evals`
        comes from objective.program_eval_tensors (numpy or tensors).
        Returns a flat dict of scalars + per-example arrays."""
        gt_tokens = to_host(batch["program_tokens"])
        gt_len = to_host(batch["program_len"])[:, 0].astype(np.int64)
        res = {}
        for name, tok_key, len_key, same_key in [
                ("", "pred_tokens", "pred_len", "pred_is_same_seq"),
                ("greedy_", "greedy_tokens", "greedy_len",
                 "greedy_is_same_seq")]:
            if tok_key not in evals:
                continue
            tokens = to_host(evals[tok_key])
            lens = to_host(evals[len_key])
            same = to_host(evals[same_key])
            syntax, exact = self.syntax_and_exact(
                tokens, lens, same, gt_tokens, gt_len)
            res[f"{name}is_correct_syntax"] = syntax
            res[f"{name}exact_program_correct"] = exact
            res[f"{name}program_syntax_acc"] = float(syntax.mean())
            res[f"{name}exact_program_acc"] = float(exact.mean())

            nc, per_demo = self.execution_compact(tokens, lens, same, batch)
            res[f"{name}program_is_correct_execution"] = per_demo
            res[f"{name}program_num_execution_correct"] = nc
            res[f"{name}program_execution_acc_hist"] = \
                self.execution_histogram(nc, self.cfg.k)
            res[f"{name}program_execution_all_correct"] = float(
                (nc == self.cfg.k).mean())

            tnc, _ = self.execution_compact(tokens, lens, same, batch,
                                            test=True)
            res[f"test_{name}program_num_execution_correct"] = tnc
            res[f"test_{name}program_execution_acc_hist"] = \
                self.execution_histogram(tnc, self.cfg.test_k)
            res[f"test_{name}program_execution_all_correct"] = float(
                (tnc == self.cfg.test_k).mean())
        return res
