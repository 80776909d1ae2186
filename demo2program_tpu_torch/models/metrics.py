"""Sequence loss / accuracy with the reference's mask semantics.

Port of demo2program_tpu/models/metrics.py (`Sequence_Loss`,
`model_full.py:620-711`). optax's softmax cross entropy is -sum(labels *
log_softmax(logits)) and its sigmoid BCE is -labels * log_sigmoid(logits) -
(1 - labels) * log_sigmoid(-logits). With bf16 logits both take the log
terms in bf16 and the products with the f32 labels in f32, as jnp promotes.

Every function here also takes extra LEADING dims in front of (bs, L, V):
the masks then reduce over (bs, L) separately per leading index, which is
how the per-demo terms (the JAX package's vmap over k) are computed.
"""

import torch
import torch.nn.functional as F


def _length_mask(lengths, max_len):
    ar = torch.arange(max_len, device=lengths.device)
    return (ar < lengths[..., None]).float()


def sequence_metrics(logits, gt_onehot, gt_len, pred_len, seq_type="program",
                     pred_tokens=None):
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
    loss = (ce * gt_mask).sum((-2, -1)) / gt_mask.sum((-2, -1)).clamp(min=1.0)

    out = {"loss": loss}
    if seq_type in ("program", "action"):
        gt_am = torch.argmax(gt_onehot, dim=-1)
        pred_am = (torch.argmax(logits, dim=-1) if pred_tokens is None
                   else pred_tokens.long())
        correct = (gt_am == pred_am).float()
        out["token_acc"] = (correct * min_mask).sum((-2, -1)) / max_mask.sum(
            (-2, -1)).clamp(min=1.0)
        seq_eq = ((gt_am == pred_am) | (gt_mask < 0.5)).all(dim=-1)
        is_same_seq = (seq_eq & (gt_len == pred_len)).float()
        out["is_same_seq"] = is_same_seq
        out["seq_acc"] = is_same_seq.mean(-1)
        out["pred_tokens"] = pred_am.int()
    return out
