"""Plain PyTorch reference of the benchmark's Karel configurations.

Written from the published model (demo2program, Sun et al., ICML 2018:
the demo encoder, the relation-network summary, the program, action and
perception decoders, and their losses) with plain torch operations on a
dict of weights keyed as the port's checkpoints key them. It imports
nothing of the program: no module, no kernel, no weights it made.

Float32, with every matmul and conv at full float32 (the caller turns TF32
off). `Arith(control=True)` rounds the operands of every matmul and conv
to TF32 (10 mantissa bits, round to nearest even), the precision below the
configuration's: the control that the comparison has to fail.

Conventions the configurations state, kept here as published:
  * the state CNN: three 3x3 stride-2 convs (16, 32, 48 channels) with
    "SAME" padding, each followed by leaky ReLU (0.2) and then batch norm
    (eps 1e-3, batch statistics in training, the stored ones in eval);
  * LSTM gates z = [x, h] W + b in the order (i, f, g, o);
  * a demo's LSTM freezes past its length and outputs zeros there;
  * teacher forcing feeds a start id past the embedding table (a zero
    row); greedy decoding starts from the id `dim_program_token`;
  * the full model's loss is program CE + mean over k of the action CE and
    of the perception BCE, each normalised by its own mask;
  * Adam (0.9, 0.999, eps 1e-8) after clipping by global norm 20.
"""

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.reference.karel_dsl.karel_world import (
    KarelWorld, batch_to_states)

BN_EPS = 1e-3
CLIP_NORM = 20.0
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def tf32(x):
    """float32 -> the nearest value with TF32's 10 mantissa bits; the
    gradient passes through as it would through the unrounded value."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded.view(x.shape) - x).detach()


class Arith:
    """The reference's matmul and conv: float32, or TF32 operands for the
    control."""

    def __init__(self, control=False):
        self.control = control

    def _r(self, t):
        return tf32(t) if self.control else t

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def conv(self, x, w, b, stride):
        return F.conv2d(self._r(x), self._r(w), b, stride)


# -- parameters ---------------------------------------------------------------

def dims(cfg):
    """The model's sizes from a configuration file's dict."""
    return dict(H=cfg["num_lstm_cell_units"], V=cfg["dim_program_token"],
                A=cfg["action_space"], P=cfg["per_dim"], C=cfg["depth"],
                h=cfg["h"], w=cfg["w"])


def _conv_out(n):
    for _ in range(3):
        n = -(-n // 2)
    return n


def param_specs(cfg):
    """[(name, shape, init)] of the model's parameters, in the checkpoint's
    names; init is lecun (truncated normal, std sqrt(1 / fan_in)), glorot
    (uniform), embed (U[0, 0.02)), zeros or ones."""
    d = dims(cfg)
    H = d["H"]
    specs = []

    def bn(prefix, n):
        specs.extend([(prefix + "bn.weight", (n,), "ones"),
                      (prefix + "bn.bias", (n,), "zeros")])

    def lstm(prefix, din):
        specs.extend([(prefix + "kernel", (din + H, 4 * H), "glorot"),
                      (prefix + "bias", (4 * H,), "zeros")])

    def fc(prefix, din, dout):
        specs.extend([(prefix + "dense.weight", (dout, din), "lecun"),
                      (prefix + "dense.bias", (dout,), "zeros")])
        bn(prefix + "bn_act.", dout)

    def decoder(prefix, vocab):
        specs.append((prefix + "core.embedding", (vocab + 1, H), "embed"))
        lstm(prefix + "core.cell.", H)
        specs.append((prefix + "core.output_projection.weight", (vocab, H),
                      "lecun"))

    se = "encoder.demo_encoder.state_encoder."
    for i, (cin, cout) in enumerate(((d["C"], 16), (16, 32), (32, 48)), 1):
        specs.extend([(f"{se}conv{i}.conv.weight", (cout, cin, 3, 3),
                       "lecun"),
                      (f"{se}conv{i}.conv.bias", (cout,), "zeros")])
        bn(f"{se}conv{i}.bn_act.", cout)
    feat = 48 * _conv_out(d["h"]) * _conv_out(d["w"])
    lstm("encoder.demo_encoder.lstm.cell.", feat)
    if cfg["model"] == "full":
        lstm("encoder.second_path.lstm.cell.", H)
        for which in ("h", "c"):
            p = f"encoder.demo_{which}_summary.rn_pool."
            fc(p + "fc1.", 2 * H, H)
            fc(p + "fc2.", H, H)
        decoder("program_decoder.", d["V"])
        decoder("action_decoder.", d["A"])
        fc("per_decoder.per_embed.", d["P"], H)
        lstm("per_decoder.cell.", H)
        specs.append(("per_decoder.output_projection.weight", (d["P"], H),
                      "lecun"))
    elif cfg["model"] == "synthesis_baseline":
        decoder("program_decoder.", d["V"])
    else:
        raise ValueError(f"no reference for model {cfg['model']!r}")
    return specs


# -- layers -------------------------------------------------------------------

def lrelu(x):
    return torch.where(x >= 0, x, 0.2 * x)


def batch_norm(x, w, prefix, train, stats):
    """Batch norm over dim 1 with the weights under prefix + "bn."; batch
    statistics (biased variance) in training, else `stats`' stored ones."""
    red = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    if train:
        mean = x.mean(red)
        var = x.var(red, unbiased=False)
    else:
        mean = stats[prefix + "bn.running_mean"]
        var = stats[prefix + "bn.running_var"]
    y = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + BN_EPS)
    return (y * w[prefix + "bn.weight"].reshape(shape)
            + w[prefix + "bn.bias"].reshape(shape))


def same_pad(n, k=3, s=2):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def state_features(w, frames, ar, train, stats):
    """(N, h, w, C) frames -> (N, 48 * h' * w') features, flattened in
    (h, w, channel) order."""
    x = frames.permute(0, 3, 1, 2)
    se = "encoder.demo_encoder.state_encoder."
    for i in (1, 2, 3):
        top, bottom = same_pad(x.shape[2])
        left, right = same_pad(x.shape[3])
        x = F.pad(x, (left, right, top, bottom))
        p = f"{se}conv{i}."
        x = ar.conv(x, w[p + "conv.weight"], w[p + "conv.bias"], 2)
        x = batch_norm(lrelu(x), w, p + "bn_act.", train, stats)
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def lstm_step(x, h, c, kernel, bias, ar):
    z = ar.mm(torch.cat([x, h], dim=1), kernel) + bias
    i, f, g, o = z.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm(w, prefix, xs, ar, init=None, lengths=None):
    """xs (B, T, D) -> (outputs (B, T, H), h, c); frozen past `lengths`."""
    B, T, _ = xs.shape
    kernel, bias = w[prefix + "kernel"], w[prefix + "bias"]
    H = bias.shape[0] // 4
    if init is None:
        c = h = xs.new_zeros(B, H)
    else:
        c, h = init
    outs = []
    for t in range(T):
        h2, c2 = lstm_step(xs[:, t], h, c, kernel, bias, ar)
        if lengths is None:
            h, c = h2, c2
            outs.append(h2)
            continue
        live = (t < lengths)[:, None]
        h = torch.where(live, h2, h)
        c = torch.where(live, c2, c)
        outs.append(torch.where(live, h2, torch.zeros_like(h2)))
    return torch.stack(outs, dim=1), h, c


def embed(table, ids):
    """Rows of `table`; ids past the table embed to zeros."""
    valid = (ids >= 0) & (ids < table.shape[0])
    return table[ids.clamp(0, table.shape[0] - 1)] * valid[..., None]


def decode_along(w, prefix, c, h, input_ids, ar):
    """The decoder fed `input_ids` (B, L) from (c, h) -> logits (B, L, V)."""
    xs = embed(w[prefix + "core.embedding"], input_ids)
    outs, _, _ = lstm(w, prefix + "core.cell.", xs, ar, init=(c, h))
    return ar.mm(outs, w[prefix + "core.output_projection.weight"].t())


def fc(w, prefix, x, ar, train, stats, activation=True):
    y = ar.mm(x, w[prefix + "dense.weight"].t()) + w[prefix + "dense.bias"]
    return batch_norm(lrelu(y) if activation else y, w, prefix + "bn_act.",
                      train, stats)


def rn_pool(w, prefix, feat, ar, train, stats):
    """Relation network over the k demos: every pair (i, j) as
    [feat_j, feat_i] through two FC layers, mean over the pairs."""
    bs, k, v = feat.shape
    pairs = torch.cat([feat[:, None, :, :].expand(bs, k, k, v),
                       feat[:, :, None, :].expand(bs, k, k, v)], dim=3)
    x = fc(w, prefix + "fc1.", pairs.reshape(bs * k * k, 2 * v), ar, train,
           stats)
    x = fc(w, prefix + "fc2.", x, ar, train, stats)
    return x.reshape(bs, k, k, -1).mean(dim=(1, 2))


# -- the models ---------------------------------------------------------------

def encode(w, cfg, s_h, demo_len, ar, train, stats):
    """s_h (bs, k, T, h, w, C), demo_len (bs, k) -> dict of the program
    decoder's start (c, h) and, for the full model, every demo's (c, h)."""
    bs, k, T = s_h.shape[:3]
    lengths = demo_len.reshape(bs * k)
    feats = state_features(w, s_h.reshape((bs * k * T,) + s_h.shape[3:]),
                           ar, train, stats).reshape(bs * k, T, -1)
    hist, h1, c1 = lstm(w, "encoder.demo_encoder.lstm.cell.", feats, ar,
                        lengths=lengths)
    H = h1.shape[1]
    if cfg["model"] == "synthesis_baseline":
        return {"c": c1.reshape(bs, k, H).mean(1),
                "h": h1.reshape(bs, k, H).mean(1)}
    sc = c1.reshape(bs, k, H).mean(1).repeat_interleave(k, dim=0)
    sh = h1.reshape(bs, k, H).mean(1).repeat_interleave(k, dim=0)
    _, h2, c2 = lstm(w, "encoder.second_path.lstm.cell.", hist, ar,
                     init=(sc, sh), lengths=lengths)
    demo_h, demo_c = h2.reshape(bs, k, H), c2.reshape(bs, k, H)
    return {
        "h": demo_h.mean(1) + rn_pool(w, "encoder.demo_h_summary.rn_pool.",
                                      demo_h, ar, train, stats),
        "c": demo_c.mean(1) + rn_pool(w, "encoder.demo_c_summary.rn_pool.",
                                      demo_c, ar, train, stats),
        "demo_h": h2, "demo_c": c2}


def masked_ce(logits, targets, lengths):
    """Sum over positions t < length of -log softmax(logits)[target], over
    the mask's sum. logits (..., B, T, V), targets (..., B, T, V) one-hot
    or zero rows, lengths (..., B)."""
    T = logits.shape[-2]
    mask = (torch.arange(T, device=logits.device) < lengths[..., None])
    ce = -(targets * F.log_softmax(logits, dim=-1)).sum(-1)
    return (ce * mask).sum((-2, -1)) / mask.sum((-2, -1)).clamp(min=1)


def loss(w, cfg, batch, ar, train=True, stats=None):
    """The training objective of cfg's model on an expanded batch."""
    d = dims(cfg)
    enc = encode(w, cfg, batch["s_h"], batch["demo_len"], ar, train, stats)
    tokens = batch["program_tokens"]
    bs = tokens.shape[0]
    start = torch.full((bs, 1), d["V"] + 1, dtype=tokens.dtype,
                       device=tokens.device)
    logits = decode_along(w, "program_decoder.", enc["c"], enc["h"],
                          torch.cat([start, tokens[:, :-1]], dim=1), ar)
    total = masked_ce(logits, F.one_hot(tokens, d["V"]).float(),
                      batch["program_len"])
    if cfg["model"] != "full":
        return total
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
           train, stats, activation=False).reshape(bs * k, T, -1)
    outs, _, _ = lstm(w, "per_decoder.cell.", x, ar,
                      init=(enc["demo_c"], enc["demo_h"]))
    per_logits = ar.mm(outs, w["per_decoder.output_projection.weight"].t())
    bce = (-per * F.logsigmoid(per_logits)
           - (1 - per) * F.logsigmoid(-per_logits)).mean(-1)
    mask = (torch.arange(T, device=dl.device) < dl.reshape(bs * k, 1))
    per_k = ((bce * mask).reshape(bs, k, T).sum((0, 2))
             / mask.reshape(bs, k, T).sum((0, 2)).clamp(min=1))
    return total + act + per_k.mean()


# -- the data: demos replayed from their compact form -------------------------

def expand(compact, cfg, device):
    """A compact Karel batch (numpy: initial states, recorded actions,
    tokens) -> the model's inputs on `device`: every seen demo replayed by
    the Karel world without errors (a blocked move turns the agent
    around), its states, percepts and action targets."""
    d = dims(cfg)
    wall, marker, agent = (compact[k] for k in ("c_wall", "c_marker",
                                                "c_agent"))
    acts = compact["c_a_raw"].astype(np.int64)
    dl = compact["demo_len"].astype(np.int64)
    bs, k, T = acts.shape
    s_h = np.zeros((bs, k, T, d["h"], d["w"], d["C"]), np.float32)
    per = np.zeros((bs, k, T, d["P"]), np.float32)
    init = batch_to_states(wall.reshape(bs * k, d["h"], d["w"]).astype(bool),
                           marker.reshape(bs * k, d["h"], d["w"]),
                           agent.reshape(bs * k, 3).astype(np.int64))
    for n in range(bs * k):
        b, j = divmod(n, k)
        world = KarelWorld(init[n], make_error=False)
        for a in acts[b, j, :dl[b, j] - 1]:
            world.state_transition(int(a))
        s_h[b, j, :len(world.s_h)] = np.stack(world.s_h)
        per[b, j, :len(world.p_v_h)] = np.stack(world.p_v_h)
    row = compact["c_a_row_len"][:, 0].astype(np.int64)[:, None, None]
    t = np.arange(T)[None, None, :]
    a_tok = np.where(t < row, acts, np.where(t == row, d["A"] - 1, 0))
    a_h = np.eye(d["A"], dtype=np.float32)[a_tok] * (t <= row)[..., None]

    def dev(a, dtype=None):
        return torch.as_tensor(a, device=device, dtype=dtype)

    return {
        "s_h": dev(s_h), "per": dev(per), "demo_len": dev(dl),
        "a_h": dev(a_h), "a_h_tokens": dev(a_h.argmax(-1)),
        "program_tokens": dev(compact["program_tokens"], torch.int64),
        "program_len": dev(compact["program_len"][:, 0], torch.int64)}


# -- training -----------------------------------------------------------------

def learning_rate_at(cfg, count):
    """The rate of the update that follows `count` applied updates: the
    configuration's rate, halved every 10000 updates (staircase) when
    `lr_weight_decay` is set."""
    rate = cfg["learning_rate"]
    return rate * 0.5 ** (count // 10000) if cfg["lr_weight_decay"] else rate


def train(cfg, start, batches, ar, device):
    """len(batches) Adam steps on the compact `batches`, as the
    configuration states them, from `start`: {"params": {name: tensor},
    "m": and "v": Adam's moments by name (None: zeros), "t": the updates
    applied before} -> (losses, {name: norm of the first clipped
    gradient}, {name: the parameters' change after the last step}, {name:
    the first clipped gradient}), the tensors on the CPU."""
    names = [n for n, _, _ in param_specs(cfg)]
    weights0 = start["params"]
    params = [weights0[n].detach().clone().requires_grad_() for n in names]
    m = [torch.zeros_like(p) if start["m"] is None else
         start["m"][n].detach().clone() for n, p in zip(names, params)]
    v = [torch.zeros_like(p) if start["v"] is None else
         start["v"][n].detach().clone() for n, p in zip(names, params)]
    losses, first = [], None
    for i, compact in enumerate(batches):
        count = start["t"] + i
        t = count + 1
        w = dict(zip(names, params))
        value = loss(w, cfg, expand(compact, cfg, device), ar)
        grads = torch.autograd.grad(value, params)
        losses.append(float(value.detach()))
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = 1.0 if float(norm) < CLIP_NORM else CLIP_NORM / norm
        grads = [g * scale for g in grads]
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        rate = learning_rate_at(cfg, count)
        with torch.no_grad():
            for p, g, m_, v_ in zip(params, grads, m, v):
                m_.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v_.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m_ / (1 - BETAS[0] ** t)
                vhat = v_ / (1 - BETAS[1] ** t)
                p.sub_(rate * mhat / (vhat.sqrt() + ADAM_EPS))
    change = {n: (p.detach() - weights0[n]).cpu()
              for n, p in zip(names, params)}
    # norms on the card: the CPU's float32 norm of a large leaf is off by
    # some 1e-4
    norms = {n: float(g.norm()) for n, g in first.items()}
    return losses, norms, change, {n: g.cpu() for n, g in first.items()}


# -- greedy decoding, scored --------------------------------------------------

@torch.no_grad()
def eval_logits(w, stats, cfg, compact, served, ar, device):
    """A compact eval batch, the model in eval mode (stored batch-norm
    statistics `stats`), and the greedy tokens served for it -> (the
    teacher-forced program loss of the batch, the logits (bs, L, V) at each
    position of the served tokens, decoded from the greedy start id along
    them, and those logits' loss against the ground truth)."""
    d = dims(cfg)
    batch = expand(compact, cfg, device)
    enc = encode(w, cfg, batch["s_h"], batch["demo_len"], ar, False, stats)
    tokens = batch["program_tokens"]
    bs = tokens.shape[0]
    start = torch.full((bs, 1), d["V"] + 1, dtype=tokens.dtype,
                       device=device)
    logits = decode_along(w, "program_decoder.", enc["c"], enc["h"],
                          torch.cat([start, tokens[:, :-1]], dim=1), ar)
    value = float(masked_ce(logits, F.one_hot(tokens, d["V"]).float(),
                            batch["program_len"]))
    served = torch.as_tensor(served, device=device, dtype=torch.int64)
    start = torch.full((bs, 1), d["V"], dtype=torch.int64, device=device)
    along = decode_along(w, "program_decoder.", enc["c"], enc["h"],
                         torch.cat([start, served[:, :-1]], dim=1), ar)
    greedy = float(masked_ce(along, F.one_hot(tokens, d["V"]).float(),
                             batch["program_len"]))
    return value, along, greedy


def widest_gaps(along, chosen, lengths):
    """Per example, the widest gap by which the logit of the `chosen`
    token lies below the best logit of `along`, over positions before
    `lengths` -> (bs,) numpy."""
    chosen = torch.as_tensor(chosen, device=along.device, dtype=torch.int64)
    gap = along.max(-1).values - along.gather(2, chosen[..., None])[..., 0]
    live = (torch.arange(chosen.shape[1], device=along.device)[None, :]
            < torch.as_tensor(lengths, device=along.device)[:, None])
    return torch.where(live, gap, torch.zeros_like(gap)).max(1).values.cpu(
        ).numpy()
