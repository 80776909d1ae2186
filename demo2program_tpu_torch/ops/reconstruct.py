"""On-device demo reconstruction from the compact wire format.

Port of demo2program_tpu/ops/reconstruct.py. A compact batch carries only
the initial state and the recorded actions of each demo:

    c_wall (bs, k, h, w) uint8      c_marker (bs, k, h, w) uint8
    c_agent (bs, k, 3) uint8        c_a_raw (bs, k, T) int8
    c_a_row_len (bs, 1) int32       (+ test_* twins, program tokens, lens)

and `expand_batch` rebuilds state frames, perception vectors and the
action/program one-hots on the device. The replay uses the no-error
semantics (blocked moves turn 180, marker over/underflow is a no-op), which
reproduces both dataset flavours exactly (see the JAX module's notes).

A ViZDoom batch gathered from the device cache (train/device_cache.py:
DoomDeviceCache) carries its frames and percepts whole (`dc_s_h`, `dc_per`:
engine video cannot be replayed) and the raw action rows; `expand_batch`
dispatches it on `dc_s_h` to `expand_doom_batch`, which rebuilds only the
program and action one-hots.

Integer ops are bit-exact with the JAX package: `%` is floor-mod on negative
ints (never torch.fmod), and every gathered index is clipped or in range.
"""

import numpy as np
import torch
import torch.nn.functional as F

# facing: 0 N, 1 E, 2 S, 3 W (reference karel.py:66-91)
_FRONT = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]], dtype=np.int64)
_LEFT = np.array([[0, -1], [-1, 0], [0, 1], [1, 0]], dtype=np.int64)
_RIGHT = np.array([[0, 1], [1, 0], [0, -1], [-1, 0]], dtype=np.int64)

MAX_MARKER_CAP = 9  # reference karel.py:174 quirk: put is a no-op at >9

COMPACT_KEY = "c_wall"


def _table(tab, device):
    t = torch.as_tensor(tab, device=device)
    return t[:, 0], t[:, 1]


def _clear_at(wall_f, y, x, d, dy_tab, dx_tab, h, w):
    """Is the cell next to (y, x) in direction table[d] inside and free?
    -> (clear, clipped y, clipped x)."""
    ny = y + dy_tab[d]
    nx = x + dx_tab[d]
    inb = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    nyc = ny.clamp(0, h - 1)
    nxc = nx.clamp(0, w - 1)
    blocked = wall_f.gather(1, (nyc * w + nxc)[:, None])[:, 0]
    return inb & ~blocked, nyc, nxc


def replay_actions(wall, marker0, agent0, actions, demo_len):
    """Replay recorded actions from compact initial states.

    wall (B, h, w), marker0 (B, h, w), agent0 (B, 3) = (y, x, facing),
    actions (B, T) zero-padded (the first demo_len-1 are applied),
    demo_len (B,) state-history lengths.

    Returns per-step compact states: y, x, d (B, T) int32, markers
    (B, T, h, w) int32, wall (B, h, w) bool. Entries at t >= demo_len
    repeat the final state."""
    B, h, w = wall.shape
    T = actions.shape[1]
    dev = wall.device
    wall_f = wall.reshape(B, h * w).bool()
    front_dy, front_dx = _table(_FRONT, dev)
    demo_len = demo_len.long()
    actions = actions.long()

    y, x, d = (agent0[:, i].long() for i in range(3))
    markers = marker0.reshape(B, h * w).long()
    ys, xs, ds, ms = [y], [x], [d], [markers]
    for t in range(T - 1):
        a = actions[:, t]
        active = t < demo_len - 1
        front_ok, fy, fx = _clear_at(wall_f, y, x, d, front_dy, front_dx,
                                     h, w)
        cell = (y * w + x)[:, None]
        here = markers.gather(1, cell)[:, 0]

        a_move = a == 0
        a_turn = (a == 1) | (a == 2)
        do_move = a_move & front_ok
        y_new = torch.where(do_move, fy, y)
        x_new = torch.where(do_move, fx, x)
        d_new = torch.where(a_turn, (d + torch.where(a == 1, -1, 1)) % 4, d)
        # no-error mode: a blocked move turns 180 (karel.py:150-154)
        d_new = torch.where(a_move & ~front_ok, (d + 2) % 4, d_new)

        delta = torch.where((a == 3) & (here > 0), -1,
                            torch.where((a == 4) & (here < MAX_MARKER_CAP),
                                        1, 0))
        markers = markers.scatter_add(
            1, cell, torch.where(active, delta, 0)[:, None])
        y = torch.where(active, y_new, y)
        x = torch.where(active, x_new, x)
        d = torch.where(active, d_new, d)
        ys.append(y)
        xs.append(x)
        ds.append(d)
        ms.append(markers)

    return {
        "y": torch.stack(ys, 1).int(),
        "x": torch.stack(xs, 1).int(),
        "d": torch.stack(ds, 1).int(),
        "markers": torch.stack(ms, 1).reshape(B, T, h, w).int(),
        "wall": wall.bool(),
    }


def _step_mask(demo_len, T):
    ar = torch.arange(T, device=demo_len.device)
    return (ar[None, :] < demo_len.long()[:, None]).float()


def assemble_states(rep, demo_len):
    """Compact per-step states -> (B, T, h, w, 16) float32, zeroed at
    t >= demo_len (matching the stored zero padding)."""
    y, x, d, markers, wall = (rep["y"].long(), rep["x"].long(),
                              rep["d"].long(), rep["markers"].long(),
                              rep["wall"])
    B, T = y.shape
    h, w = wall.shape[1], wall.shape[2]
    pos = F.one_hot(y * w + x, h * w).float().reshape(B, T, h, w)
    agent = pos[..., None] * F.one_hot(d, 4).float()[:, :, None, None, :]
    wall_ch = wall.float()[:, None, :, :, None].expand(B, T, h, w, 1)
    marker_ch = F.one_hot(markers, 11).float()
    s = torch.cat([agent, wall_ch, marker_ch], dim=-1)
    return s * _step_mask(demo_len, T)[:, :, None, None, None]


def compute_percepts(rep, demo_len):
    """Per-step perception vectors (front/left/right clear, markersPresent,
    noMarkersPresent; `karel_env/karel.py:97-132`), zeroed at
    t >= demo_len."""
    y, x, d, markers, wall = (rep["y"].long(), rep["x"].long(),
                              rep["d"].long(), rep["markers"], rep["wall"])
    B, T = y.shape
    h, w = wall.shape[1], wall.shape[2]
    wall_f = wall.reshape(B, 1, h * w).expand(B, T, h * w).reshape(
        B * T, h * w)

    def clear(tab):
        dy, dx = _table(tab, y.device)
        ok, _, _ = _clear_at(wall_f, y.reshape(-1), x.reshape(-1),
                             d.reshape(-1), dy, dx, h, w)
        return ok.reshape(B, T)

    here = markers.reshape(B, T, h * w).gather(
        2, (y * w + x)[:, :, None])[:, :, 0]
    present = here > 0
    per = torch.stack([clear(_FRONT), clear(_LEFT), clear(_RIGHT), present,
                       ~present], dim=-1).float()
    return per * _step_mask(demo_len, T)[:, :, None]


def _action_supervision(raw, row_len, action_space, num_action_tokens):
    """The reference loader's quirky action one-hots (`dataset_karel.py:
    66-94`): tokens AND the zero padding up to the per-item row width, then
    <e> at exactly that width; rows beyond are all-zero.

    raw (bs, k, T) int, row_len (bs,) int ->
    (onehot (bs, k, T, A) float32, tokens (bs, k, T) int32)."""
    T = raw.shape[2]
    t = torch.arange(T, device=raw.device)[None, None, :]
    rl = row_len.long()[:, None, None]
    tok = torch.where(t < rl, raw.long(),
                      torch.where(t == rl, num_action_tokens, 0))
    onehot = F.one_hot(tok, action_space).float() * (t <= rl)[..., None]
    return onehot, torch.argmax(onehot, dim=-1).int()


def is_compact(batch):
    return COMPACT_KEY in batch


def _fold(a):
    return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))


def replay_seen(batch, cfg):
    """Replay the SEEN demos -> (folded compact states (bs*k, T, ...),
    bs, k) for the VM scorer."""
    bs, k = batch["c_wall"].shape[:2]
    return replay_actions(
        _fold(batch["c_wall"]), _fold(batch["c_marker"]),
        _fold(batch["c_agent"]), _fold(batch["c_a_raw"]),
        _fold(batch["demo_len"])), bs, k


def replay_test(batch, cfg):
    bs, tk = batch["test_c_wall"].shape[:2]
    return replay_actions(
        _fold(batch["test_c_wall"]), _fold(batch["test_c_marker"]),
        _fold(batch["test_c_agent"]), _fold(batch["test_c_a_raw"]),
        _fold(batch["test_demo_len"])), bs, tk


def _program_onehot(out, batch, cfg):
    """program one-hot (bs, V, L), zero columns beyond program_len."""
    tok = batch["program_tokens"].long()
    out["program_tokens"] = tok.int()
    plen = batch["program_len"][:, 0].long()
    L = tok.shape[1]
    tmask = _step_mask(plen, L)
    prog = F.one_hot(tok, cfg.dim_program_token).float() * tmask[..., None]
    out["program"] = prog.transpose(1, 2)


def expand_doom_batch(batch, cfg):
    """Device-cached ViZDoom batch -> the full batch dict
    (demo2program_tpu/ops/reconstruct.py:252-271): frames and percepts are
    passed through, the program one-hot and the quirky action supervision
    rebuilt."""
    out = {key: batch[key] for key in
           ("program_len", "demo_len", "test_demo_len") if key in batch}
    _program_onehot(out, batch, cfg)
    out["s_h"] = batch["dc_s_h"]
    out["per"] = batch["dc_per"]
    out["a_h"], out["a_h_tokens"] = _action_supervision(
        batch["c_a_raw"], batch["c_a_row_len"][:, 0], cfg.action_space,
        cfg.action_space - 1)
    if "test_c_a_raw" in batch:
        out["test_a_h"], out["test_a_h_tokens"] = _action_supervision(
            batch["test_c_a_raw"], batch["test_c_a_row_len"][:, 0],
            cfg.action_space, cfg.action_space - 1)
    return out


def expand_batch(batch, cfg):
    """Compact Karel batch or device-cached ViZDoom batch (dict of tensors
    on one device) -> the full batch dict the model and objective read.
    Full-wire batches pass through."""
    if "dc_s_h" in batch:
        return expand_doom_batch(batch, cfg)
    if not is_compact(batch):
        return batch
    out = {key: batch[key] for key in
           ("program_len", "demo_len", "test_demo_len") if key in batch}
    _program_onehot(out, batch, cfg)

    rep, bs, k = replay_seen(batch, cfg)
    dlen = _fold(batch["demo_len"])
    s = assemble_states(rep, dlen)
    per = compute_percepts(rep, dlen)
    T = s.shape[1]
    out["s_h"] = s.reshape((bs, k, T) + tuple(s.shape[2:]))
    out["per"] = per.reshape(bs, k, T, cfg.per_dim)

    out["a_h"], out["a_h_tokens"] = _action_supervision(
        batch["c_a_raw"], batch["c_a_row_len"][:, 0], cfg.action_space,
        cfg.action_space - 1)
    if "test_c_a_raw" in batch:
        out["test_a_h"], out["test_a_h_tokens"] = _action_supervision(
            batch["test_c_a_raw"], batch["test_c_a_row_len"][:, 0],
            cfg.action_space, cfg.action_space - 1)
    return out
