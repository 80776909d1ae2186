"""Operations and bytes of the ViZDoom full model: the train step's model
FLOPs, and the least time of the two parts this configuration makes
heavy, the frame CNN and the relation-network pool.

Operations count each matmul and conv once (2 x the multiply-adds), as
counts/model_flops.py counts Karel's. The train step is 3 x the forward:
the backward's two products per forward product.

The least time of a call is max(operations / F32_FLOPS, bytes /
HBM_BYTES). TF32 is off for the configuration's float32 convs and GEMMs
(train/step.py:full_precision_matmuls), so they run on the CUDA cores,
whose float32 peak is F32_FLOPS. Bytes count what no implementation can
avoid: the call's input read once, its output written once, and, since
batch norm needs every row's batch statistics before it normalises any,
each conv's or FC's output written once and read once.
"""

from bench_torch.counts import peaks

# NVIDIA H100 SXM data sheet: FP32, 67 TFLOP/s (CUDA cores, no tensor
# cores), the rate of float32 convs and GEMMs with TF32 off
F32_FLOPS = 67e12

CONV_CHANNELS = (16, 32, 48, 48, 48)
F32 = 4


def _halve(n):
    return -(-n // 2)


def conv_shapes(h, w, depth):
    """[(out h, out w, cin, cout)] of the five 3x3 stride-2 SAME convs."""
    out, cin = [], depth
    for cout in CONV_CHANNELS:
        h, w = _halve(h), _halve(w)
        out.append((h, w, cin, cout))
        cin = cout
    return out


def frame_encoder_ops(frames, h, w, depth):
    """FLOPs of the frame CNN's convs over `frames` frames."""
    return sum(2 * frames * oh * ow * cout * cin * 9
               for oh, ow, cin, cout in conv_shapes(h, w, depth))


def frame_encoder_bytes(frames, h, w, depth):
    """The uint8 frames read, each conv's float32 output written and read
    once, the features written once (the last conv's output), and the
    weights, biases and batch-norm parameters read once."""
    shapes = conv_shapes(h, w, depth)
    acts = sum(oh * ow * cout for oh, ow, _, cout in shapes)
    params = sum(cout * cin * 9 + 3 * cout for _, _, cin, cout in shapes)
    return frames * (h * w * depth + 2 * F32 * acts) + F32 * params


def frame_encoder_least_time(frames, h, w, depth):
    return max(frame_encoder_ops(frames, h, w, depth) / F32_FLOPS,
               frame_encoder_bytes(frames, h, w, depth) / peaks.HBM_BYTES)


def rn_pool_ops(rows, units):
    """FLOPs of the pool's two FC GEMMs over `rows` pair rows:
    (2 units -> units) and (units -> units)."""
    return 2 * rows * (2 * units * units + units * units)


def rn_pool_bytes(rows, units, bs, k):
    """The bs x k demo features read, each FC's float32 output written and
    read once, the bs pooled outputs written, and the two FCs' weights,
    biases and batch-norm parameters read once."""
    params = 2 * units * units + units * units + 2 * 3 * units
    return F32 * ((bs * k + bs + 2 * 2 * rows) * units + params)


def rn_pool_least_time(rows, units, bs, k):
    return max(rn_pool_ops(rows, units) / F32_FLOPS,
               rn_pool_bytes(rows, units, bs, k) / peaks.HBM_BYTES)


def _lstm(B, D, H, steps):
    return steps * 2 * B * (D + H) * 4 * H


def forward_flops(cfg):
    """FLOPs of one train-mode forward of the full model (the program
    decoder teacher-forced, no greedy decoding) at cfg's batch size."""
    if cfg["model"] != "full":
        raise ValueError(f"no ViZDoom count for model {cfg['model']!r}")
    bs, k = cfg["batch_size"], cfg["num_k"]
    T, L, H = cfg["max_demo_len"], cfg["max_program_len"], cfg[
        "num_lstm_cell_units"]
    V, A, P = cfg["dim_program_token"], cfg["action_space"], cfg["per_dim"]
    h, w, depth = cfg["h"], cfg["w"], cfg["depth"]
    oh, ow, _, cout = conv_shapes(h, w, depth)[-1]
    feat = oh * ow * cout
    demos = bs * k
    total = frame_encoder_ops(demos * T, h, w, depth)          # frame CNN
    total += _lstm(demos, feat, H, T) + _lstm(demos, H, H, T)  # two passes
    total += 2 * rn_pool_ops(bs * k * k, H)                    # two RN pools
    total += _lstm(bs, H, H, L) + 2 * bs * L * H * V           # program
    total += _lstm(demos, H, H, T) + 2 * demos * T * H * A     # action
    total += (2 * demos * T * P * H + _lstm(demos, H, H, T)
              + 2 * demos * T * H * P)                         # perception
    return total


def train_step_flops(cfg):
    return 3 * forward_flops(cfg)
