"""Model FLOPs of a Karel configuration's train step, from its shapes.

Each matmul and conv of the train-mode forward counted once (2 x the
multiply-adds); elementwise work, gathers and the loss are not counted.
The train step is 3 x the forward: the backward's two products per
forward product. The LSTM backward's recompute of its forward is the
implementation's and is not counted."""


def _conv_flops(frames, h, w, depth):
    total, cin = 0, depth
    for cout in (16, 32, 48):
        h, w = -(-h // 2), -(-w // 2)
        total += 2 * frames * h * w * cout * cin * 9
        cin = cout
    return total, 48 * h * w


def _lstm(B, D, H, steps):
    return steps * 2 * B * (D + H) * 4 * H


def forward_flops(cfg):
    """FLOPs of one train-mode forward (the program decoder teacher-forced,
    no greedy decoding) at cfg's batch size."""
    bs, k = cfg["batch_size"], cfg["num_k"]
    T, L, H = cfg["max_demo_len"], cfg["max_program_len"], cfg[
        "num_lstm_cell_units"]
    V, A, P = cfg["dim_program_token"], cfg["action_space"], cfg["per_dim"]
    conv, feat = _conv_flops(bs * k * T, cfg["h"], cfg["w"], cfg["depth"])
    total = conv + _lstm(bs * k, feat, H, T)                 # demo encoder
    total += _lstm(bs, H, H, L) + 2 * bs * L * H * V          # program decoder
    if cfg["model"] == "synthesis_baseline":
        return total
    if cfg["model"] != "full":
        raise ValueError(f"no count for model {cfg['model']!r}")
    total += _lstm(bs * k, H, H, T)                          # second pass
    pairs = bs * k * k
    total += 2 * (2 * pairs * 2 * H * H + 2 * pairs * H * H)  # two RN pools
    total += _lstm(bs * k, H, H, T) + 2 * bs * k * T * H * A  # action decoder
    total += (2 * bs * k * T * P * H + _lstm(bs * k, H, H, T)
              + 2 * bs * k * T * H * P)                       # per decoder
    return total


def train_step_flops(cfg):
    return 3 * forward_flops(cfg)
