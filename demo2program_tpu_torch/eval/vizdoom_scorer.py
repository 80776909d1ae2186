"""ViZDoom program scoring: syntax, canonical-program equality, execution
accuracy in the game engine.

Port of demo2program_tpu/eval/vizdoom_scorer.py (`model_full.py:789-846`).
Syntax and canonical checks are host string work on the ViZDoom DSL.
Execution replays each predicted program in the engine (DoomLite unless the
`vizdoom` package is installed, envs/vizdoom.py) from the stored initial
actor positions, shrinks its frames to the dataset's resolution with
utils/area_resize.py (cv2's INTER_AREA, bit for bit) and compares them with
the stored demo: correct iff every frame and the length match, OR the token
sequences matched exactly. One engine instance is reused across rollouts.

The batch is read on the host (numpy arrays, or tensors copied back):
`s_h`, `demo_len`, `init_pos`, `init_pos_len` and their `test_` twins.
`timings` holds the seconds of the host string work ("host", span
`d2p.score.host`) and of the engine replays ("vm", span `d2p.score.vm`, the
name the Evaler reads for the Karel VM), the process's totals of those
spans (utils/spans.py), as KarelScorer's.
"""

import numpy as np

from demo2program_tpu_torch.dsl import (
    vizdoom_canonical, vizdoom_interp, vizdoom_parser)
from demo2program_tpu_torch.dsl.vizdoom_vocab import VizDoomDSLVocab
from demo2program_tpu_torch.eval.scorer import TIMINGS, to_host
from demo2program_tpu_torch.utils import spans
from demo2program_tpu_torch.utils.area_resize import area_resize


class VizdoomScorer:
    def __init__(self, cfg, vocab=None, engine_config=None):
        # engine_config None: the packaged assets/doomlite.cfg
        self.cfg = cfg
        self.vocab = vocab or VizDoomDSLVocab(
            perception_type=cfg.perception_type, level=cfg.level or
            "not_simple")
        self.engine_config = engine_config
        self._world = None
        self.timings = spans.TotalsView(**TIMINGS)

    # -- host-side string metrics (engine-free) -------------------------------
    def syntax_and_exact(self, pred_tokens, pred_len, is_same_seq,
                         gt_tokens, gt_len):
        with spans.span("d2p.score.host"):
            bs = pred_tokens.shape[0]
            syntax = np.zeros(bs, np.float32)
            exact = np.zeros(bs, np.float32)
            for i in range(bs):
                if is_same_seq[i] == 1:
                    syntax[i] = 1.0
                else:
                    p_str = self.vocab.intseq2str(
                        pred_tokens[i, :int(pred_len[i])])
                    _, ok = vizdoom_parser.parse(p_str)
                    syntax[i] = float(ok)
                if syntax[i] == 1.0:
                    p_str = self.vocab.intseq2str(
                        pred_tokens[i, :int(pred_len[i])])
                    g_str = self.vocab.intseq2str(
                        gt_tokens[i, :int(gt_len[i])])
                    exact[i] = float(
                        vizdoom_canonical.programs_equal(p_str, g_str))
        return syntax, exact

    # -- engine-backed execution accuracy -------------------------------------
    def _get_world(self):
        if self._world is None:
            from demo2program_tpu_torch.envs.vizdoom import Vizdoom_env
            self._world = Vizdoom_env(
                config=self.engine_config,
                perception_type=self.cfg.perception_type,
                sprite_style=getattr(self.cfg, "sprite_style", "v2"))
            self._world.init_game()
        return self._world

    def _reproduces(self, ast, init_pos, init_pos_len, target, target_len):
        """Run `ast` from one demo's initial positions: does it succeed and
        give exactly the stored frames?"""
        world = self._get_world()
        init_dict = {}
        for p, key in enumerate(self.cfg.vizdoom_pos_keys):
            n_pos = int(init_pos_len[p])
            init_dict[key] = np.squeeze(init_pos[p, :n_pos])
        world.new_episode(init_dict)
        _, success = vizdoom_interp.execute(ast, world)
        if not success:
            return False
        h, w = self.cfg.h, self.cfg.w
        frames = np.stack(world.s_h, 0)
        if frames.shape[1:3] != (h, w):
            frames = area_resize(frames, (h, w))
        if len(frames) != int(target_len):
            return False
        target = target[:len(frames)]
        return bool((frames.astype(target.dtype) == target).all())

    def execution(self, pred_tokens, pred_len, is_same_seq,
                  s_h, demo_len, init_pos, init_pos_len):
        """Returns (num_correct (bs,), is_correct (bs, k))."""
        with spans.span("d2p.score.vm"):
            bs, k = s_h.shape[0], s_h.shape[1]
            is_correct = np.zeros([bs, k], bool)
            for i in range(bs):
                if is_same_seq[i] == 1:
                    is_correct[i, :] = True
                    continue
                p_str = self.vocab.intseq2str(
                    pred_tokens[i, :int(pred_len[i])])
                ast, ok = vizdoom_parser.parse(p_str)
                if not ok:
                    continue
                for d in range(k):
                    is_correct[i, d] = self._reproduces(
                        ast, init_pos[i, d], init_pos_len[i, d], s_h[i, d],
                        demo_len[i, d])
        return is_correct.sum(axis=1).astype(np.float32), is_correct

    def execution_histogram(self, num_correct, k):
        hist = np.zeros(k + 1, np.float32)
        for i in range(k + 1):
            hist[i] = float((num_correct == i).sum()) / len(num_correct)
        return hist

    def rerank_pick(self, beam_tokens, beam_lens, batch):
        """Execution-guided beam selection against the SEEN demos (the
        model's inputs, no test information): per example, the first
        (highest-scoring: beams arrive score-sorted) beam that reproduces
        every seen demo wins, else the best-scoring beam. Stops at the first
        demo a beam misses. Returns pick (bs,) int."""
        with spans.span("d2p.score.vm"):
            s_h = to_host(batch["s_h"])
            demo_len = to_host(batch["demo_len"])
            init_pos = to_host(batch["init_pos"])
            init_pos_len = to_host(batch["init_pos_len"])
            bs, K, _ = beam_tokens.shape
            k = s_h.shape[1]
            pick = np.zeros(bs, np.int64)
            for i in range(bs):
                for j in range(K):
                    p_str = self.vocab.intseq2str(
                        beam_tokens[i, j, :int(beam_lens[i, j])])
                    ast, ok = vizdoom_parser.parse(p_str)
                    if ok and all(self._reproduces(
                            ast, init_pos[i, d], init_pos_len[i, d], s_h[i, d],
                            demo_len[i, d]) for d in range(k)):
                        pick[i] = j
                        break
        return pick

    def score_batch(self, batch, evals, skip_execution=False):
        """Same contract as KarelScorer.score_batch. `skip_execution=True`
        scores syntax/canonical only (no engine)."""
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
            if skip_execution:
                continue
            nc, per_demo = self.execution(
                tokens, lens, same, to_host(batch["s_h"]),
                to_host(batch["demo_len"]), to_host(batch["init_pos"]),
                to_host(batch["init_pos_len"]))
            res[f"{name}program_is_correct_execution"] = per_demo
            res[f"{name}program_num_execution_correct"] = nc
            res[f"{name}program_execution_acc_hist"] = \
                self.execution_histogram(nc, self.cfg.k)
            res[f"{name}program_execution_all_correct"] = float(
                (nc == self.cfg.k).mean())
            tnc, _ = self.execution(
                tokens, lens, same, to_host(batch["test_s_h"]),
                to_host(batch["test_demo_len"]),
                to_host(batch["test_init_pos"]),
                to_host(batch["test_init_pos_len"]))
            res[f"test_{name}program_num_execution_correct"] = tnc
            res[f"test_{name}program_execution_acc_hist"] = \
                self.execution_histogram(tnc, self.cfg.test_k)
            res[f"test_{name}program_execution_all_correct"] = float(
                (tnc == self.cfg.test_k).mean())
        return res
