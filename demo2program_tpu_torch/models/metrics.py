"""Sequence loss / accuracy with the reference's mask semantics.

Port of demo2program_tpu/models/metrics.py (`Sequence_Loss`,
`model_full.py:620-711`). optax's softmax cross entropy is -sum(labels *
log_softmax(logits)) and its sigmoid BCE is -labels * log_sigmoid(logits) -
(1 - labels) * log_sigmoid(-logits). With bf16 logits both take the log
terms in bf16 and the products with the f32 labels in f32, as jnp promotes.

Every function here also takes extra LEADING dims in front of (bs, L, V):
the masks then reduce over (bs, L) separately per leading index, which is
how the per-demo terms (the JAX package's vmap over k) are computed.

Under data parallelism (`mesh`, parallel/mesh.py) a rank holds bs rows of
the global batch: each mean divides the rank's sum by the GLOBAL
denominator (mask sums summed across the ranks without a gradient, row
counts times the mesh size), so the returned scalars are partial sums whose
sum over the ranks is the value over the global batch, as the JAX step
computes it over its sharded batch. On a 2-D mesh a rank holds k / D of the
seen demos: a per-demo term reduces over the data axis
(parallel/mesh.py:data_axis) and `k_mean` divides by the global k.
"""

import torch
import torch.nn.functional as F

from demo2program_tpu_torch.parallel.mesh import global_sum, world_of


def _length_mask(lengths, max_len):
    ar = torch.arange(max_len, device=lengths.device)
    return (ar < lengths[..., None]).float()


def batch_mean(x, mesh=None):
    """Mean over the last (batch) axis of the global batch: a partial sum
    under a mesh."""
    return x.sum(-1) / (x.shape[-1] * world_of(mesh))


def k_mean(x, mesh=None):
    """Mean over the leading (demo) axis of the global k demos, of which
    the rank holds x.shape[0]: a partial sum on a 2-D mesh."""
    demo_par = 1 if mesh is None else mesh.demo_par
    return x.sum(0) / (x.shape[0] * demo_par)


def sequence_metrics(logits, gt_onehot, gt_len, pred_len, seq_type="program",
                     pred_tokens=None, mesh=None):
    """Returns dict(loss, token_acc, seq_acc, is_same_seq, pred_tokens).

    logits/gt_onehot: (..., bs, L, V); gt_len/pred_len: (..., bs) int.
    For seq_type='per' only the loss is meaningful. `pred_tokens` (..., bs,
    L) replaces the logits' argmax as the prediction (scheduled sampling
    reports its sampled ids)."""
    L = logits.shape[-2]
    gt_onehot = gt_onehot.float()  # labels may arrive as uint8
    gt_len = gt_len.long()
    pred_len = pred_len.long()
    gt_mask = _length_mask(gt_len, L)
    max_mask = _length_mask(torch.maximum(gt_len, pred_len), L)
    min_mask = _length_mask(torch.minimum(gt_len, pred_len), L)

    if seq_type in ("program", "action"):
        ce = -(gt_onehot * F.log_softmax(logits, dim=-1)).sum(-1)
    else:
        ce = (-gt_onehot * F.logsigmoid(logits)
              - (1.0 - gt_onehot) * F.logsigmoid(-logits)).mean(-1)
    loss = (ce * gt_mask).sum((-2, -1)) / global_sum(
        gt_mask.sum((-2, -1)), mesh).clamp(min=1.0)

    out = {"loss": loss}
    if seq_type in ("program", "action"):
        gt_am = torch.argmax(gt_onehot, dim=-1)
        pred_am = (torch.argmax(logits, dim=-1) if pred_tokens is None
                   else pred_tokens.long())
        correct = (gt_am == pred_am).float()
        out["token_acc"] = (correct * min_mask).sum((-2, -1)) / global_sum(
            max_mask.sum((-2, -1)), mesh).clamp(min=1.0)
        seq_eq = ((gt_am == pred_am) | (gt_mask < 0.5)).all(dim=-1)
        is_same_seq = (seq_eq & (gt_len == pred_len)).float()
        out["is_same_seq"] = is_same_seq
        out["seq_acc"] = batch_mean(is_same_seq, mesh)
        out["pred_tokens"] = pred_am.int()
    return out
