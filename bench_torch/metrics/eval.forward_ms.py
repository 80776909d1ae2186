"""eval.forward_ms: the eval forward's seconds (copy to the device,
replay, model, greedy decode, objective, ending in the copy of the evals to
the host) a window batch, in ms."""


def read(layer):
    fwd = layer.get("forward_s")
    return 1e3 * sum(fwd) / len(fwd) if fwd else None
