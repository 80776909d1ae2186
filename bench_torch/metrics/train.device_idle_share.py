"""train.device_idle_share: 1 - (device busy seconds a profiled train
step) / (seconds a step of the profiler-off window), in %
(harness/trace.py:idle_share)."""

from bench_torch.harness.trace import idle_share


def read(layer):
    return idle_share(layer)
