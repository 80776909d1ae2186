"""Loss + on-device metric assembly.

Port of demo2program_tpu/models/objective.py (`model_full.py:918-1095`):

  full:                 program_CE + mean_k(action_CE_k) + mean_k(per_CE_k)
  synthesis_baseline,
  summarizer:           program_CE
  induction_baseline:   mean over the test demos of their action CE
                        (`model_induction.py:788-819`)

each per-demo term normalised by its own mask sum before the mean over k.
Host-side metrics (syntax, canonical program, execution accuracy) live in
eval/scorer.py. With a data `mesh` every batch reduction is over the global
batch and every scalar is the rank's partial sum (models/metrics.py): the
local losses sum over the ranks to the single-process loss. On a 2-D mesh
the seen demos' per-demo terms (the full model's action and perception
heads, and in eval its greedy action decoder's) reduce over the data axis
and divide by the global k; the program and the induction model's test
demos are replicated across the demo group and reduce over the world like
every other term (parallel/mesh.py).
"""

import torch

from demo2program_tpu_torch.models.metrics import (
    batch_mean, k_mean, sequence_metrics)
from demo2program_tpu_torch.parallel.mesh import data_axis


def _program_stat(logits, batch, pred_tokens=None, mesh=None):
    gt_onehot = batch["program"].transpose(1, 2).float()  # -> (bs, L, V)
    plen = batch["program_len"][:, 0].long()
    return sequence_metrics(logits, gt_onehot, plen, plen, "program",
                            pred_tokens=pred_tokens, mesh=mesh)


def _per_k_stats(logits, gt_onehot, gt_len, seq_type, pred_len=None,
                 mesh=None):
    """Per-demo sequence metrics with a leading k axis, like the JAX
    package's vmap over k. logits/gt: (bs, k, T, V); lengths: (bs, k).
    `mesh`: the mesh of the demos' reductions (data_axis for the seen
    demos)."""
    gt_len = gt_len.transpose(0, 1)
    pred_len = gt_len if pred_len is None else pred_len.transpose(0, 1)
    return sequence_metrics(logits.transpose(0, 1),
                            gt_onehot.transpose(0, 1), gt_len, pred_len,
                            seq_type, mesh=mesh)


def _all_k_match(stats, mesh=None):
    """`seq_all_acc`: the share of tasks whose sequences ALL match
    (`model_induction.py:816-819`); stats have a leading k axis."""
    return batch_mean((stats["is_same_seq"] > 0.5).all(dim=0).float(), mesh)


def compute_loss(cfg, outputs, batch, model_name, mesh=None):
    """Training objective of `model_name` -> (loss, report) with the
    reference's report_loss/report_accuracy scalar names
    (`model_full.py:1099-1132`); with `mesh`, the rank's partial sums of
    the global batch's values."""
    report = {}
    if model_name == "induction_baseline":
        act = _per_k_stats(outputs["pred_action_logits"], batch["test_a_h"],
                           batch["test_demo_len"].long(), "action",
                           mesh=mesh)
        loss = act["loss"].mean()
        report["avg_action_loss"] = loss
        report["avg_action_token_acc"] = act["token_acc"].mean()
        report["avg_action_seq_acc"] = act["seq_acc"].mean()
        report["avg_action_seq_all_acc"] = _all_k_match(act, mesh)
        report["loss"] = loss
        return loss, report

    # scheduled sampling reports its sampled ids, not the logits' argmax
    prog = _program_stat(outputs["pred_program_logits"], batch,
                         outputs.get("pred_program_tokens"), mesh)
    loss = prog["loss"]
    report["program_loss"] = prog["loss"]
    report["program_token_acc"] = prog["token_acc"]
    report["program_seq_acc"] = prog["seq_acc"]

    if model_name == "full":
        demo_len = batch["demo_len"].long()  # action_len alias
        seen = data_axis(mesh)
        act = _per_k_stats(outputs["pred_action_logits"], batch["a_h"],
                           demo_len, "action", mesh=seen)
        report["avg_action_loss"] = k_mean(act["loss"], mesh)
        report["avg_action_token_acc"] = k_mean(act["token_acc"], mesh)
        report["avg_action_seq_acc"] = k_mean(act["seq_acc"], mesh)

        per = _per_k_stats(outputs["pred_per_logits"], batch["per"],
                           demo_len, "per", mesh=seen)
        report["avg_per_loss"] = k_mean(per["loss"], mesh)
        loss = loss + report["avg_action_loss"] + report["avg_per_loss"]

    report["loss"] = loss
    return loss, report


def program_eval_tensors(cfg, outputs, batch, image_tensors=False, mesh=None):
    """Per-example tensors for the host/VM scorers, for the teacher-forced
    and the decoded programs (and the beam set of beam decoding) (the fetch
    set of `evaler.py:258-280`). With `image_tensors`, also the trainer's
    image summaries' perception head probabilities (`pred_per`,
    (bs, k, T, P)) and first demo's action probabilities
    (`pred_action_probs`, (bs, T, A)), demo2program_tpu/models/
    objective.py:128-137, which the JAX function always returns; those two
    are float32 whatever the compute dtype (JAX keeps the logits' dtype),
    so they cross to numpy. Empty for the induction baseline, which decodes
    no program. With `mesh` the scalars are the rank's partial sums; the
    per-example tensors are the rank's rows."""
    if "pred_program_logits" not in outputs:
        return {}
    prog = _program_stat(outputs["pred_program_logits"], batch, mesh=mesh)
    plen = batch["program_len"][:, 0].long()
    res = {
        "pred_tokens": prog["pred_tokens"],
        "pred_len": plen.int(),
        "pred_is_same_seq": prog["is_same_seq"],
        "program_loss": prog["loss"],
        "program_token_acc": prog["token_acc"],
        "program_seq_acc": prog["seq_acc"],
    }
    g = sequence_metrics(outputs["greedy_program_logits"],
                         batch["program"].transpose(1, 2), plen,
                         outputs["greedy_program_len"], "program",
                         mesh=mesh)
    res.update({
        "greedy_tokens": outputs["greedy_program_tokens"],
        "greedy_len": outputs["greedy_program_len"],
        "greedy_is_same_seq": g["is_same_seq"],
        "greedy_program_loss": g["loss"],
        "greedy_program_token_acc": g["token_acc"],
        "greedy_program_seq_acc": g["seq_acc"],
    })
    for key in ("beam_tokens", "beam_lengths", "beam_scores"):
        if key in outputs:  # the whole beam set, for execution reranking
            res[key] = outputs[key]
    if image_tensors and "pred_per_logits" in outputs:
        res["pred_per"] = torch.sigmoid(outputs["pred_per_logits"]).float()
    if image_tensors and "pred_action_logits" in outputs:
        res["pred_action_probs"] = torch.softmax(
            outputs["pred_action_logits"][:, 0], dim=-1).float()
    return res


def greedy_action_report(cfg, outputs, batch, model_name, mesh=None):
    """greedy_avg_action_* scalars (`model_full.py:1040-1059`); the
    induction baseline is scored against the TEST demos and adds
    seq_all_acc (`model_induction.py:822-846`). Empty for the models
    without an action decoder."""
    if "greedy_action_logits" not in outputs:
        return {}
    induction = model_name == "induction_baseline"
    gt, lens = ((batch["test_a_h"], batch["test_demo_len"]) if induction
                else (batch["a_h"], batch["demo_len"]))
    # the test demos are whole on every rank; the seen demos are the rank's
    # k / D on a 2-D mesh and reduce as compute_loss's do
    seen = None if induction else mesh
    stats = _per_k_stats(outputs["greedy_action_logits"], gt, lens.long(),
                         "action",
                         pred_len=outputs["greedy_action_len"].long(),
                         mesh=mesh if induction else data_axis(mesh))
    report = {
        "greedy_avg_action_loss": k_mean(stats["loss"], seen),
        "greedy_avg_action_token_acc": k_mean(stats["token_acc"], seen),
        "greedy_avg_action_seq_acc": k_mean(stats["seq_acc"], seen),
    }
    if induction:
        report["greedy_avg_action_seq_all_acc"] = _all_k_match(stats, mesh)
    return report
