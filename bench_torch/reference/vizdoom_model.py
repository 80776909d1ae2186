"""Plain PyTorch reference of the benchmark's ViZDoom full model.

The demo2program full model (Sun et al., ICML 2018) on ViZDoom, written
from the published model with plain torch operations on a dict of weights
keyed as the port's checkpoints key them. It imports nothing of the
program and nothing of JAX; from the Karel reference (karel_model.py) it
takes the layers the two domains share: the LSTM, the relation-network
pool, the FC and batch-norm layers, the decoders' teacher forcing, the
masked losses, Arith and its TF32 control.

Float32, with every matmul and conv at full float32: `train` turns TF32
off for cuBLAS and cuDNN. `Arith(control=True)` rounds the
operands of every matmul and conv to TF32, the precision below the
configuration's: the control that the comparison has to fail.

What ViZDoom changes against Karel, as published:
  * the frame CNN: five 3x3 stride-2 convs (16, 32, 48, 48, 48 channels)
    with "SAME" padding on 80x80x3 frames (80 -> 40 -> 20 -> 10 -> 5 -> 3,
    432 features), each followed by leaky ReLU (0.2) and batch norm;
  * the frames are the raw 0..255 pixel values, as the reference loader
    feeds them; the percepts are the engine's "simple" perception vectors;
  * the batch is the loader's full-wire batch (`expand`), with its action
    supervision: the recorded actions and their zero padding up to the
    item's widest action row, the end token at exactly that width, zero
    rows beyond;
  * the vocabulary, the action and the percept sizes are those of the
    split's data_info, stated in the configuration.

Departures from the paper: the batch statistics of batch norm are taken in
two passes (the mean, then the mean square distance from it), as
tf.nn.moments takes them, where the port follows flax; Adam runs at a
constant rate (the ViZDoom recipe's stage 1), with no decay.
"""

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference.karel_model import (
    ADAM_EPS, BETAS, CLIP_NORM, Arith, batch_norm, decode_along, fc, lrelu,
    lstm, masked_ce, rn_pool, same_pad)  # noqa: F401 (Arith, for callers)

CONV_CHANNELS = (16, 32, 48, 48, 48)
SE = "encoder.demo_encoder.state_encoder."


def dims(cfg):
    """The model's sizes from a configuration file's dict."""
    return dict(H=cfg["num_lstm_cell_units"], V=cfg["dim_program_token"],
                A=cfg["action_space"], P=cfg["per_dim"], C=cfg["depth"],
                h=cfg["h"], w=cfg["w"])


def conv_out(n):
    for _ in CONV_CHANNELS:
        n = -(-n // 2)
    return n


def param_specs(cfg):
    """[(name, shape, init)] of the full model's parameters, in the
    checkpoint's names (inits as karel_model.param_specs)."""
    if cfg["model"] != "full":
        raise ValueError(f"no ViZDoom reference for model {cfg['model']!r}")
    d = dims(cfg)
    H = d["H"]
    specs = []

    def bn(prefix, n):
        specs.extend([(prefix + "bn.weight", (n,), "ones"),
                      (prefix + "bn.bias", (n,), "zeros")])

    def lstm_cell(prefix, din):
        specs.extend([(prefix + "kernel", (din + H, 4 * H), "glorot"),
                      (prefix + "bias", (4 * H,), "zeros")])

    def fc_layer(prefix, din, dout):
        specs.extend([(prefix + "dense.weight", (dout, din), "lecun"),
                      (prefix + "dense.bias", (dout,), "zeros")])
        bn(prefix + "bn_act.", dout)

    def decoder(prefix, vocab):
        specs.append((prefix + "core.embedding", (vocab + 1, H), "embed"))
        lstm_cell(prefix + "core.cell.", H)
        specs.append((prefix + "core.output_projection.weight", (vocab, H),
                      "lecun"))

    cin = d["C"]
    for i, cout in enumerate(CONV_CHANNELS, 1):
        specs.extend([(f"{SE}conv{i}.conv.weight", (cout, cin, 3, 3),
                       "lecun"),
                      (f"{SE}conv{i}.conv.bias", (cout,), "zeros")])
        bn(f"{SE}conv{i}.bn_act.", cout)
        cin = cout
    feat = cin * conv_out(d["h"]) * conv_out(d["w"])
    lstm_cell("encoder.demo_encoder.lstm.cell.", feat)
    lstm_cell("encoder.second_path.lstm.cell.", H)
    for which in ("h", "c"):
        p = f"encoder.demo_{which}_summary.rn_pool."
        fc_layer(p + "fc1.", 2 * H, H)
        fc_layer(p + "fc2.", H, H)
    decoder("program_decoder.", d["V"])
    decoder("action_decoder.", d["A"])
    fc_layer("per_decoder.per_embed.", d["P"], H)
    lstm_cell("per_decoder.cell.", H)
    specs.append(("per_decoder.output_projection.weight", (d["P"], H),
                  "lecun"))
    return specs


# -- the model ----------------------------------------------------------------

def frame_features(w, frames, ar):
    """(N, 80, 80, 3) raw pixel values -> (N, 48 * 3 * 3) features,
    flattened in (h, w, channel) order; batch norm on batch statistics."""
    x = frames.permute(0, 3, 1, 2)
    for i in range(1, len(CONV_CHANNELS) + 1):
        top, bottom = same_pad(x.shape[2])
        left, right = same_pad(x.shape[3])
        x = F.pad(x, (left, right, top, bottom))
        p = f"{SE}conv{i}."
        x = ar.conv(x, w[p + "conv.weight"], w[p + "conv.bias"], 2)
        x = batch_norm(lrelu(x), w, p + "bn_act.", True, None)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def encode(w, s_h, demo_len, ar):
    """s_h (bs, k, T, h, w, C), demo_len (bs, k) -> the program decoder's
    start (c, h) and every demo's (c, h): a CNN+LSTM pass per demo, the
    mean of its final states over the demos, a second LSTM pass from that
    mean, and the summaries mean + relation-network pool."""
    bs, k, T = s_h.shape[:3]
    lengths = demo_len.reshape(bs * k)
    feats = frame_features(w, s_h.reshape((bs * k * T,) + s_h.shape[3:]),
                           ar).reshape(bs * k, T, -1)
    hist, h1, c1 = lstm(w, "encoder.demo_encoder.lstm.cell.", feats, ar,
                        lengths=lengths)
    H = h1.shape[1]
    sc = c1.reshape(bs, k, H).mean(1).repeat_interleave(k, dim=0)
    sh = h1.reshape(bs, k, H).mean(1).repeat_interleave(k, dim=0)
    _, h2, c2 = lstm(w, "encoder.second_path.lstm.cell.", hist, ar,
                     init=(sc, sh), lengths=lengths)
    demo_h, demo_c = h2.reshape(bs, k, H), c2.reshape(bs, k, H)
    return {
        "h": demo_h.mean(1) + rn_pool(w, "encoder.demo_h_summary.rn_pool.",
                                      demo_h, ar, True, None),
        "c": demo_c.mean(1) + rn_pool(w, "encoder.demo_c_summary.rn_pool.",
                                      demo_c, ar, True, None),
        "demo_h": h2, "demo_c": c2}


def loss(w, cfg, batch, ar):
    """The training objective on an expanded batch: program CE + mean over
    k of the action CE and of the perception BCE, each normalised by its
    own mask."""
    d = dims(cfg)
    enc = encode(w, batch["s_h"], batch["demo_len"], ar)
    tokens = batch["program_tokens"]
    bs = tokens.shape[0]
    start = torch.full((bs, 1), d["V"] + 1, dtype=tokens.dtype,
                       device=tokens.device)
    logits = decode_along(w, "program_decoder.", enc["c"], enc["h"],
                          torch.cat([start, tokens[:, :-1]], dim=1), ar)
    total = masked_ce(logits, F.one_hot(tokens, d["V"]).float(),
                      batch["program_len"])
    k, T = batch["s_h"].shape[1], batch["s_h"].shape[2]
    act_tok = batch["a_h_tokens"].reshape(bs * k, T)
    start = torch.full((bs * k, 1), d["A"] + 1, dtype=act_tok.dtype,
                       device=act_tok.device)
    act_logits = decode_along(w, "action_decoder.", enc["demo_c"],
                              enc["demo_h"],
                              torch.cat([start, act_tok[:, :-1]], dim=1), ar)
    dl = batch["demo_len"]
    act = masked_ce(act_logits.reshape(bs, k, T, -1).transpose(0, 1),
                    batch["a_h"].transpose(0, 1), dl.t()).mean()
    per = batch["per"].reshape(bs * k, T, d["P"])
    x = fc(w, "per_decoder.per_embed.", per.reshape(bs * k * T, d["P"]), ar,
           True, None, activation=False).reshape(bs * k, T, -1)
    outs, _, _ = lstm(w, "per_decoder.cell.", x, ar,
                      init=(enc["demo_c"], enc["demo_h"]))
    per_logits = ar.mm(outs, w["per_decoder.output_projection.weight"].t())
    bce = (-per * F.logsigmoid(per_logits)
           - (1 - per) * F.logsigmoid(-per_logits)).mean(-1)
    mask = (torch.arange(T, device=dl.device) < dl.reshape(bs * k, 1))
    per_k = ((bce * mask).reshape(bs, k, T).sum((0, 2))
             / mask.reshape(bs, k, T).sum((0, 2)).clamp(min=1))
    return total + act + per_k.mean()


# -- the data: the loader's full-wire batch -----------------------------------

def expand(items, cfg, device):
    """The generator's items (per item: `s_h` (demos, frames, h, w, C)
    pixels, `p_v_h` percepts, `a_h` (demos, row width) recorded actions,
    `s_h_len`, `program` tokens) -> the model's inputs on `device`, with
    k = cfg's num_k seen demos padded to T = cfg's max_demo_len frames and
    the programs to L = max_program_len tokens."""
    d = dims(cfg)
    k, T, L, A = (cfg["num_k"], cfg["max_demo_len"], cfg["max_program_len"],
                  d["A"])
    bs = len(items)
    s_h = np.zeros((bs, k, T, d["h"], d["w"], d["C"]), np.float32)
    per = np.zeros((bs, k, T, d["P"]), np.float32)
    acts = np.zeros((bs, k, T), np.int64)
    row = np.zeros((bs, 1, 1), np.int64)
    dl = np.zeros((bs, k), np.int64)
    tokens = np.zeros((bs, L), np.int64)
    plen = np.zeros(bs, np.int64)
    for b, g in enumerate(items):
        frames = np.asarray(g["s_h"])[:k]
        s_h[b, :, :frames.shape[1]] = frames
        pv = np.asarray(g["p_v_h"])[:k]
        per[b, :, :pv.shape[1]] = pv
        a = np.asarray(g["a_h"])[:k]
        acts[b, :, :a.shape[1]] = a
        row[b] = a.shape[1]
        dl[b] = np.asarray(g["s_h_len"])[:k]
        prog = np.asarray(g["program"])
        tokens[b, :len(prog)] = prog
        plen[b] = len(prog)
    # the loader's action supervision: tokens and padding below the row
    # width, the end token (A - 1) at it, zero rows beyond
    t = np.arange(T)[None, None, :]
    a_tok = np.where(t < row, acts, np.where(t == row, A - 1, 0))
    a_h = np.eye(A, dtype=np.float32)[a_tok] * (t <= row)[..., None]

    def dev(a, dtype=None):
        return torch.as_tensor(a, device=device, dtype=dtype)

    return {"s_h": dev(s_h), "per": dev(per), "demo_len": dev(dl),
            "a_h": dev(a_h), "a_h_tokens": dev(a_h.argmax(-1)),
            "program_tokens": dev(tokens), "program_len": dev(plen)}


# -- training -----------------------------------------------------------------

def train(cfg, start, batches, ar, device):
    """len(batches) Adam steps at the configuration's constant rate, each
    on a list of the generator's items, from `start`: {"params": {name:
    tensor}, "m": and "v": Adam's moments by name (None: zeros), "t": the
    updates applied before} -> (losses, {name: norm of the first clipped
    gradient}, {name: the parameters' change after the last step}, {name:
    the first clipped gradient}), the tensors on the CPU; as
    karel_model.train returns them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [n for n, _, _ in param_specs(cfg)]
    weights0 = start["params"]
    params = [weights0[n].detach().clone().requires_grad_() for n in names]
    m = [torch.zeros_like(p) if start["m"] is None else
         start["m"][n].detach().clone() for n, p in zip(names, params)]
    v = [torch.zeros_like(p) if start["v"] is None else
         start["v"][n].detach().clone() for n, p in zip(names, params)]
    rate = cfg["learning_rate"]
    losses, first = [], None
    for i, items in enumerate(batches):
        t = start["t"] + i + 1
        value = loss(dict(zip(names, params)), cfg,
                     expand(items, cfg, device), ar)
        grads = torch.autograd.grad(value, params)
        losses.append(float(value.detach()))
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = 1.0 if float(norm) < CLIP_NORM else CLIP_NORM / norm
        grads = [g * scale for g in grads]
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        with torch.no_grad():
            for p, g, m_, v_ in zip(params, grads, m, v):
                m_.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v_.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m_ / (1 - BETAS[0] ** t)
                vhat = v_ / (1 - BETAS[1] ** t)
                p.sub_(rate * mhat / (vhat.sqrt() + ADAM_EPS))
    change = {n: (p.detach() - weights0[n]).cpu()
              for n, p in zip(names, params)}
    norms = {n: float(g.norm()) for n, g in first.items()}
    return losses, norms, change, {n: g.cpu() for n, g in first.items()}
