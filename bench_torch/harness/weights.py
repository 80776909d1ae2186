"""Initial weights made by the benchmark from the run's seed, on the device,
from one draw of the generator: the same seed gives the same weights, and
neither the program nor the reference makes them."""

import math

import torch

# the std of a normal truncated at +-2 std, as a share of the untruncated
TRUNCATED_STD = 0.87962566103423978


def make(specs, seed, device):
    """{name: float32 tensor on `device`} for [(name, shape, init)]: lecun
    (normal truncated at +-2 std, std sqrt(1 / fan_in)), glorot (uniform
    +-sqrt(6 / (fan_in + fan_out))), embed (U[0, 0.02)), zeros, ones."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(sizes), generator=gen, device=device)
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    out, offset = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        u = draw[offset:offset + n].view(shape)
        offset += n
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "embed":
            out[name] = u * 0.02
        elif init == "glorot":
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (2 * u - 1) * limit
        elif init == "lecun":
            std = math.sqrt(1.0 / math.prod(shape[1:])) / TRUNCATED_STD
            p = lo + u * (hi - lo)
            out[name] = math.sqrt(2) * torch.erfinv(2 * p - 1) * std
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out


@torch.no_grad()
def load(model, weights):
    """Copy `weights` into the program's model, whose parameters must be
    exactly these names and shapes, and reset its batch-norm statistics."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"the model's parameters are not the reference's: only in the "
            f"model {sorted(set(params) - set(weights))}, only in the "
            f"reference {sorted(set(weights) - set(params))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: the model's shape {tuple(p.shape)} "
                             f"is not {tuple(weights[name].shape)}")
        p.copy_(weights[name])
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            buf.fill_(1.0)
        else:
            buf.zero_()
