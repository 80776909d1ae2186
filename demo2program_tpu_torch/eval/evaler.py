"""Evaluation loop, every model family (`--model`) on Karel and ViZDoom,
and every program decode mode (`--unroll_type greedy | syntax_greedy |
syntax_sample | beam`; the syntax modes are Karel's).

Port of demo2program_tpu/eval/evaler.py: walks a split in order, without
shuffling, for a fixed number of full batches and prints the reference's
per-batch and final loss/accuracy/histogram report lines
(`evaler.py:292-359`), then writes the summary report file
`<ckpt>_report_testdata{N}_num_k{K}.txt`.

Differences from the JAX evaler:
  * the checkpoint is the port's own: a trainer checkpoint
    (`<train_dir>/ckpt/<step>.pt`, train/checkpoint.py) or a bare
    `torch.save`d state_dict (`save_checkpoint`), by `--checkpoint`, or the
    newest one of `--train_dir`; JAX checkpoints come over through
    models/convert.py. Without one the model is drawn from `--seed`;
  * the device is explicit (`device`, the CLI's `--device`, default
    "cuda"): asking for the card without one raises, nothing falls back;
  * a Karel split only needs `ids` and `get_batch_compact(ids)` (an HDF5
    KarelDataset or data/karel_memory.py's split), a ViZDoom split `ids`,
    `get_batch(ids)` and the data_info fields (data/vizdoom_dataset.py or
    data/vizdoom_memory.py); `config_from_dataset` reads the dims from
    them;
  * the canonical-comparison counters are reset at the start of each run,
    so a checkpoint sweep (`set_checkpoint`, the CLI's `--sweep_steps`)
    reports `canonical_fallback_rate` per checkpoint (the JAX sweep
    accumulates it across checkpoints);
  * h5py is imported where `--pred_program` / `--result_data` open their
    files, before the first batch: on a host without h5py those flags raise
    at once, naming h5py, and nothing partial is written;
  * `timings` holds, per batch, the seconds of the whole batch, of the
    model forward (copy to the device + expand + model + objective, ending
    in the copy of the results to the host), of execution scoring ("vm":
    the device VM on Karel, engine replays on ViZDoom) and of host
    syntax/canonical work; with `--execution_rerank` the "vm" time includes
    the reranking's runs.

ViZDoom batches are scored by eval/vizdoom_scorer.py on the host arrays of
the batch, with the ViZDoom vocab. With `--unroll_type beam
--execution_rerank` the decoded program of each example is the
highest-scoring beam that reproduces all seen demos (scorer.rerank_pick),
and the final report adds `rerank_changed_rate`, the share of examples where
that is not the best beam. On ViZDoom, `--rerank_k N` > num_k verifies the
beams against N stored seen demos of the same task instead of the num_k the
model read (`_full_k_rerank_arrays`).

The induction baseline decodes no program: as in the JAX evaler, nothing is
scored and the report holds its action scalars only.
"""

import os
import time

import numpy as np
import torch

from demo2program_tpu_torch.dsl import karel_canonical
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.dsl.vizdoom_vocab import VizDoomDSLVocab
from demo2program_tpu_torch.envs.karel import (
    NUM_STATE_CHANNELS, PERCEPTION_NAMES)
from demo2program_tpu_torch.eval.scorer import KarelScorer, to_host
from demo2program_tpu_torch.eval.vizdoom_scorer import VizdoomScorer
from demo2program_tpu_torch.models.common import ModelConfig
from demo2program_tpu_torch.models.ops import init_parameters
from demo2program_tpu_torch.models.registry import get_model_class
from demo2program_tpu_torch.train import checkpoint as ckpt_io
from demo2program_tpu_torch.train.step import (
    make_eval_step, resolve_device, to_device)
from demo2program_tpu_torch.utils import log


def fetch_batch(dataset, ids, dataset_type):
    """The host batch of `ids`: Karel's compact wire format, ViZDoom's full
    one."""
    if dataset_type == "vizdoom":
        return dataset.get_batch(ids)
    return dataset.get_batch_compact(ids)


def program_vocab(dataset_type, perception_type="", level=None):
    if dataset_type == "vizdoom":
        return VizDoomDSLVocab(perception_type=perception_type,
                               level=level or "not_simple")
    return KarelVocab()


def config_from_dataset(args, dataset):
    """Data dims from the first item: demo2program_tpu/train/trainer.py:
    config_from_dataset, read from a compact Karel item or a full-wire
    ViZDoom one."""
    common = dict(
        model=args.model,
        dataset_type=args.dataset_type,
        batch_size=args.batch_size,
        num_lstm_cell_units=args.num_lstm_cell_units,
        encoder_rnn_type=args.encoder_rnn_type,
        demo_aggregation=args.demo_aggregation,
        scheduled_sampling=args.scheduled_sampling,
        scheduled_sampling_decay_steps=args.scheduled_sampling_decay_steps,
        cell_impl=args.cell_impl,
        compute_dtype=args.compute_dtype,
        beam_width=getattr(args, "beam_width", 5))
    if args.dataset_type == "vizdoom":
        item = dataset.get_data(dataset.ids[0])
        vocab = program_vocab("vizdoom", dataset.perception_type,
                              dataset.level)
        return ModelConfig(
            **common,
            dim_program_token=item["program"].shape[0],
            max_program_len=item["program"].shape[1],
            k=item["s_h"].shape[0],
            test_k=item["test_s_h"].shape[0],
            max_demo_len=item["s_h"].shape[1],
            h=item["s_h"].shape[2],
            w=item["s_h"].shape[3],
            depth=item["s_h"].shape[4],
            action_space=item["a_h"].shape[2],
            per_dim=item["per"].shape[2],
            dsl_type="vizdoom_default",
            env_type="vizdoom_default",
            vizdoom_pos_keys=tuple(dataset.vizdoom_pos_keys),
            vizdoom_max_init_pos_len=dataset.vizdoom_max_init_pos_len,
            perception_type=dataset.perception_type,
            level=dataset.level,
            sprite_style=getattr(dataset, "sprite_style", "v2"),
            program_end_token=vocab.end_token)
    if args.dataset_type != "karel":
        raise ValueError(f"unknown dataset_type {args.dataset_type!r}")
    item = dataset.get_batch_compact(dataset.ids[:1])
    vocab = KarelVocab()
    return ModelConfig(
        **common,
        dim_program_token=len(vocab.int2token),
        max_program_len=item["program_tokens"].shape[1],
        k=item["c_wall"].shape[1],
        test_k=item["test_c_wall"].shape[1],
        max_demo_len=item["c_a_raw"].shape[2],
        h=item["c_wall"].shape[2],
        w=item["c_wall"].shape[3],
        depth=NUM_STATE_CHANNELS,
        action_space=vocab.num_action_tokens + 1,
        per_dim=len(PERCEPTION_NAMES),
        dsl_type=dataset.dsl_type,
        env_type=dataset.env_type,
        program_end_token=vocab.end_token,
    )


def save_checkpoint(model, path):
    torch.save(model.state_dict(), path)


class _Dumps:
    """The files `--pred_program` and `--result_data` write during one
    eval_run; neither flag: nothing is opened and every call is a no-op.
    h5py is imported here, when the files are opened."""

    def __init__(self, args, checkpoint_name):
        self.text = self.hdf5 = self.log = self.result = self.data = None
        pred = getattr(args, "pred_program", False)
        result = getattr(args, "result_data", False)
        if not (pred or result):
            return
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "--pred_program and --result_data write HDF5 files and "
                "need h5py, which this host does not have") from e
        if pred:
            os.makedirs(args.output_dir, exist_ok=True)
            base = os.path.join(args.output_dir, "out_{}_{}".format(
                checkpoint_name, args.dataset_split))
            self.text = open(base + ".txt", "w")
            self.hdf5 = h5py.File(base + ".hdf5", "w")
            self.log = open(base + ".log", "w")
        if result:
            self.result = h5py.File(args.result_data_path, "w")
            self.data = h5py.File(
                os.path.join(args.dataset_path, "data.hdf5"), "r")

    def write_batch(self, evaler, batch, evals, scores, msg):
        if self.log is not None:
            self.log.write(msg + "\n")
            self.log.flush()  # one line a batch: a heartbeat for watchers
            evaler._write_artifacts(batch, evals, scores, self.text,
                                    self.hdf5)
        if self.result is not None:
            evaler._write_result_data(batch, evals, self.result, self.data)

    def close(self, final):
        if self.log is not None:
            self.log.write(final)
        for f in (self.text, self.log, self.hdf5, self.result, self.data):
            if f is not None:
                f.close()


class Evaler:
    def __init__(self, args, dataset, device="cuda"):
        self.args = args
        self.dataset = dataset
        self.device = resolve_device(device)
        self.cfg = config_from_dataset(args, dataset)
        self.vocab = program_vocab(self.cfg.dataset_type,
                                   self.cfg.perception_type, self.cfg.level)
        model = get_model_class(self.cfg.model)(self.cfg)
        self.checkpoint = args.checkpoint or ""
        train_dir = getattr(args, "train_dir", "")
        if not self.checkpoint and train_dir:
            self.checkpoint = ckpt_io.latest_checkpoint(train_dir) or ""
        self.model = model
        if self.checkpoint:
            self._load(self.checkpoint)
        else:
            log.warn("No checkpoint is given. Just random initialization :-)")
            init_parameters(model, torch.Generator().manual_seed(args.seed))
            self.checkpoint_name = "random_init"
        self.model = model.to(self.device).eval()
        self.eval_step = make_eval_step(
            self.model, self.cfg, self.cfg.model,
            decode_mode=getattr(args, "unroll_type", "greedy"))
        if self.cfg.dataset_type == "vizdoom":
            self.scorer = VizdoomScorer(self.cfg, self.vocab)
        else:
            self.scorer = KarelScorer(self.cfg, self.device, self.vocab)
        self.summary_file = self._summary_name()
        self.timings = {}

    def _load(self, path):
        """The weights and BN statistics of checkpoint `path` into the
        model, and the checkpoint's name: the file's stem, `<step>` for a
        trainer checkpoint."""
        self.model.load_state_dict(ckpt_io.model_state_dict(
            ckpt_io.load(path)))
        log.info("Loaded from checkpoint: %s", path)
        self.checkpoint_name = os.path.splitext(os.path.basename(path))[0]

    def _summary_name(self):
        # args.max_steps: the batches the run evaluates, as the CLI sets it
        return self.checkpoint + "_report_testdata{}_num_k{}.txt".format(
            self.args.max_steps * self.args.batch_size, self.args.num_k)

    def set_checkpoint(self, path):
        """Re-aim this Evaler at another checkpoint of the same run: only
        the weights move; the model, the eval step and the scorer stay
        (demo2program_tpu/eval/evaler.py:104-124)."""
        self._load(path)
        self.checkpoint = os.path.abspath(path)
        self.summary_file = self._summary_name()

    def eval_run(self):
        args = self.args
        bs = args.batch_size
        n_full = len(self.dataset.ids) // bs
        max_steps = args.max_steps or n_full
        if max_steps > n_full:
            raise ValueError(f"{max_steps} batches of {bs} asked for; the "
                             f"split holds {n_full}")
        karel_canonical.STATS.update(compares=0, cap_fallbacks=0)
        dumps = _Dumps(args, self.checkpoint_name)
        rerank = getattr(args, "execution_rerank", False)
        self._rerank_changed = self._rerank_total = 0
        timings = {"batch": [], "forward": [], "vm": [], "host": []}
        sums, hist_sums = {}, {}
        for s in range(max_steps):
            t0 = time.perf_counter()
            scorer_t0 = dict(self.scorer.timings)
            ids = self.dataset.ids[s * bs:(s + 1) * bs]
            raw = fetch_batch(self.dataset, ids, self.cfg.dataset_type)
            batch = to_device(raw, self.device)
            # ViZDoom scores on the host: its frames need not come back
            scored = raw if self.cfg.dataset_type == "vizdoom" else batch
            report, evals = self.eval_step(batch)
            report = {k: float(v) for k, v in report.items()}
            evals = {k: v.cpu().numpy() for k, v in evals.items()}
            timings["forward"].append(time.perf_counter() - t0)
            if rerank and "beam_tokens" in evals:
                self._apply_rerank(scored, evals)
            scores = self.scorer.score_batch(scored, evals) if evals else {}
            step_time = time.perf_counter() - t0
            timings["batch"].append(step_time)
            for k in ("vm", "host"):
                timings[k].append(self.scorer.timings[k] - scorer_t0[k])

            loss_d, acc_d, hist_d = self._assemble(report, evals, scores)
            msg = self._step_msg(s, loss_d, acc_d, hist_d, step_time,
                                 quiet=args.quiet)
            for d in (loss_d, acc_d):
                for k, v in d.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
            for k, v in hist_d.items():
                hist_sums[k] = hist_sums.get(k, np.zeros_like(v)) + v
            if evals:
                dumps.write_batch(self, raw, evals, scores, msg)

        loss_avg = {k: v / max_steps for k, v in sums.items()
                    if k.endswith("loss")}
        acc_avg = {k: v / max_steps for k, v in sums.items()
                   if not k.endswith("loss")}
        hist_avg = {k: v / max_steps for k, v in hist_sums.items()}
        stats = karel_canonical.STATS
        if stats["compares"]:
            acc_avg["canonical_fallback_rate"] = (
                stats["cap_fallbacks"] / stats["compares"])
        if rerank and self._rerank_total:
            acc_avg["rerank_changed_rate"] = (
                self._rerank_changed / self._rerank_total)
        self.timings = timings
        final = self._final_msg(loss_avg, acc_avg, hist_avg,
                                sum(timings["batch"]))
        if args.write_summary:
            with open(args.summary_file or self.summary_file, "w") as f:
                f.write("Model class: {}\nCheckpoint: {}\nDataset: {}\n{}"
                        .format(args.model, self.checkpoint,
                                args.dataset_path, final))
        dumps.close("{}\nModel class: {}\nCheckpoint: {}\nDataset: {}\n"
                    .format(final, args.model, self.checkpoint,
                            args.dataset_path))
        log.warning("Completed Evaluation.")
        return loss_avg, acc_avg, hist_avg

    # -- dumps (demo2program_tpu/eval/evaler.py:326-391) ----------------------
    def _write_artifacts(self, batch, evals, scores, text_file, hdf5_file):
        """One group per example in out_*.hdf5 (both programs as strings,
        their syntax and per-demo execution verdicts) and its lines in
        out_*.txt."""
        correctness = ["wrong", "correct"]
        ids = batch["id"]
        gt_tokens = np.asarray(batch["program_tokens"])
        gt_len = np.asarray(batch["program_len"])[:, 0].astype(int)
        pred_tokens = evals["pred_tokens"]
        pred_len = evals["pred_len"].astype(int)
        g_tokens = evals["greedy_tokens"]
        g_len = evals["greedy_len"].astype(int)
        for i in range(len(ids)):
            pid = str(ids[i])
            pred_str = self.vocab.intseq2str(pred_tokens[i, :pred_len[i]])
            greedy_str = self.vocab.intseq2str(g_tokens[i, :g_len[i]])
            try:
                grp = hdf5_file.create_group(pid)
            except ValueError:
                pass
            else:
                grp["program_prediction"] = pred_str
                grp["program_syntax"] = correctness[
                    int(scores["is_correct_syntax"][i])]
                grp["program_num_execution_correct"] = int(
                    scores["program_num_execution_correct"][i])
                grp["program_is_correct_execution"] = \
                    scores["program_is_correct_execution"][i]
                grp["greedy_prediction"] = greedy_str
                grp["greedy_syntax"] = correctness[
                    int(scores["greedy_is_correct_syntax"][i])]
                grp["greedy_num_execution_correct"] = int(
                    scores["greedy_program_num_execution_correct"][i])
                grp["greedy_is_correct_execution"] = \
                    scores["greedy_program_is_correct_execution"][i]
            text_file.write(
                "[id: {}]\ngt: {}\npred{}: {}\ngreedy{}: {}\n".format(
                    pid,
                    self.vocab.intseq2str(gt_tokens[i, :gt_len[i]]),
                    "(error)" if scores["is_correct_syntax"][i] == 0 else "",
                    pred_str,
                    "(error)" if scores["greedy_is_correct_syntax"][i] == 0
                    else "",
                    greedy_str))

    def _write_result_data(self, batch, evals, result_file, data_file):
        """One group per example in result.hdf5: the one-hot ground truth,
        the decoded program's ids and length, and the stored demos."""
        ids = batch["id"]
        g_tokens = evals["greedy_tokens"]
        g_len = evals["greedy_len"].astype(int)
        for i in range(len(ids)):
            pid = str(ids[i])
            try:
                grp = result_file.create_group(pid)
            except ValueError:
                log.info("Duplicates: %s", pid)
                continue
            if "program" in batch:
                grp["program"] = np.asarray(batch["program"])[i]
            else:  # compact wire: rebuild the one-hot on the host
                tok = np.asarray(batch["program_tokens"])[i]
                plen = int(np.asarray(batch["program_len"])[i, 0])
                oh = np.zeros(
                    (self.cfg.dim_program_token, tok.shape[0]), bool)
                oh[tok[:plen], np.arange(plen)] = True
                grp["program"] = oh
            grp["pred_program"] = g_tokens[i]
            grp["pred_program_len"] = g_len[i]
            grp["s_h"] = data_file[pid]["s_h"][()]
            grp["test_s_h"] = data_file[pid]["test_s_h"][()]

    def _apply_rerank(self, batch, evals):
        """Execution-guided beam selection (demo2program_tpu/eval/
        evaler.py:224-264): point the greedy_* eval arrays at the
        highest-scoring beam that reproduces all seen demos (the model's own
        inputs, no test-demo information), then recompute the picked
        programs' sequence and token accuracies on the host."""
        order = np.argsort(-evals["beam_scores"], axis=1, kind="stable")
        bt = np.take_along_axis(evals["beam_tokens"], order[:, :, None],
                                axis=1)
        bl = np.take_along_axis(evals["beam_lengths"].astype(np.int32),
                                order, axis=1)
        rerank_k = int(getattr(self.args, "rerank_k", 0) or 0)
        if rerank_k > self.cfg.k and self.cfg.dataset_type == "vizdoom":
            pick = self.scorer.rerank_pick(
                bt, bl, self._full_k_rerank_arrays(batch, rerank_k))
        else:
            pick = self.scorer.rerank_pick(bt, bl, batch)
        rows = np.arange(len(pick))
        tokens, lens = bt[rows, pick], bl[rows, pick]
        self._rerank_changed += int((pick != 0).sum())
        self._rerank_total += len(pick)

        gt_tokens = to_host(batch["program_tokens"])
        gt_len = to_host(batch["program_len"])[:, 0].astype(int)
        bs = tokens.shape[0]
        same = np.zeros(bs, np.float32)
        tok_acc = np.zeros(bs, np.float32)
        for i in range(bs):
            gl, pl = int(gt_len[i]), int(lens[i])
            m = min(gl, pl)
            match = (tokens[i, :m] == gt_tokens[i, :m]).sum()
            tok_acc[i] = match / max(gl, pl, 1)
            same[i] = float(pl == gl and match == gl)
        evals["greedy_tokens"] = tokens
        evals["greedy_len"] = lens
        evals["greedy_is_same_seq"] = same
        evals["greedy_program_seq_acc"] = same.mean()
        evals["greedy_program_token_acc"] = tok_acc.mean()

    def _full_k_rerank_arrays(self, batch, rk):
        """--rerank_k (demo2program_tpu/eval/evaler.py:266-290): the batch
        rows' SEEN demos re-read from the split's store at rk > num_k demos
        (up to the stored count), padded as get_data pads them. The extra
        seen demos belong to the same task, so the verification still uses
        no test-demo information. -> the 4 arrays rerank_pick reads."""
        ds = self.dataset
        rk = min(rk, ds.num_demo)
        s_h, dl, ip, ipl = [], [], [], []
        for id_ in batch["id"]:
            grp = ds._store[str(id_)]
            demo = grp["s_h"][()][:rk]
            pad = np.zeros([rk, ds.max_demo_len] + list(demo.shape[2:]),
                           demo.dtype)
            pad[:, :demo.shape[1]] = demo
            s_h.append(pad.astype(np.uint8))
            dl.append(grp["s_h_len"][()][:rk].astype(np.float32))
            pos = grp["vizdoom_init_pos"][()][:rk]
            ppad = np.zeros([rk, pos.shape[1],
                             ds.vizdoom_max_init_pos_len, 2], pos.dtype)
            ppad[:, :, :pos.shape[2], :] = pos
            ip.append(ppad.astype(np.int32))
            ipl.append(grp["vizdoom_init_pos_len"][()][:rk].astype(np.int32))
        return {"s_h": np.stack(s_h), "demo_len": np.stack(dl),
                "init_pos": np.stack(ip), "init_pos_len": np.stack(ipl)}

    # -- report formatting (demo2program_tpu/eval/evaler.py:292-432) --------
    def _assemble(self, report, evals, scores):
        loss_d = {k: float(v) for k, v in report.items()
                  if k.endswith("loss")}
        if not evals:  # induction: action scalars only
            acc_d = {k: float(v) for k, v in report.items()
                     if k.endswith("acc")}
            return loss_d, acc_d, {}
        acc_d = {
            "program_token_acc": float(report["program_token_acc"]),
            "program_seq_acc": float(report["program_seq_acc"]),
            "program_syntax_acc": scores["program_syntax_acc"],
            "pred_exact_program_accuracy": scores["exact_program_acc"],
            "greedy_exact_program_accuracy":
                scores["greedy_exact_program_acc"],
            "greedy_program_token_acc":
                float(evals["greedy_program_token_acc"]),
            "greedy_program_seq_acc":
                float(evals["greedy_program_seq_acc"]),
            "greedy_program_syntax_acc":
                scores["greedy_program_syntax_acc"],
        }
        loss_d["greedy_program_loss"] = float(evals["greedy_program_loss"])
        for k in ("avg_action_token_acc", "avg_action_seq_acc",
                  "greedy_avg_action_token_acc", "greedy_avg_action_seq_acc"):
            if k in report:
                acc_d[k] = float(report[k])
        hist_d = {k: np.asarray(v) for k, v in scores.items()
                  if k.endswith("_hist")}
        return loss_d, acc_d, hist_d

    def _fmt_hist(self, hist_d):
        out = ""
        for k in sorted(hist_d):
            out += "{}: [".format(k)
            for h in hist_d[k]:
                out += "{acc: .3f}, ".format(acc=h)
            out += "] "
        return out

    def _step_msg(self, step, loss_d, acc_d, hist_d, step_time, quiet=False):
        loss_str = "".join("{}:{loss: .3f} ".format(k, loss=loss_d[k])
                           for k in sorted(loss_d))
        acc_str = "".join("{}:{acc: .3f} ".format(k, acc=acc_d[k])
                          for k in sorted(acc_d))
        msg = ("[{:5s} step {:5d}] {}{}{}({:.3f} sec/batch, "
               "{:.3f} instances/sec)").format(
            "val", step, loss_str, acc_str, self._fmt_hist(hist_d),
            step_time, self.args.batch_size / max(step_time, 1e-3))
        if not quiet:
            log.infov(msg)
        return msg

    def _final_msg(self, loss_avg, acc_avg, hist_avg, t_total):
        loss_str = "".join("{}:{loss: .3f} ".format(k, loss=loss_avg[k])
                           for k in sorted(loss_avg))
        acc_str = "\n".join("{}:{acc: .3f}".format(k, acc=acc_avg[k])
                            for k in sorted(acc_avg))
        hist_str = "\n".join(
            "{}: [{}]".format(k, "".join("{acc: .3f}, ".format(acc=h)
                                         for h in hist_avg[k]))
            for k in sorted(hist_avg))
        msg = ("[Final Avg Report] \n[Loss] {}\n[Acc]  {}\n[Hist] {}\n"
               "[Time] ({:.3f} sec)").format(loss_str, acc_str, hist_str,
                                             t_total)
        log.infov(msg)
        log.infov("Model class: %s", self.args.model)
        log.infov("Checkpoint: %s", self.checkpoint)
        log.infov("Dataset: %s", self.args.dataset_path)
        return msg
