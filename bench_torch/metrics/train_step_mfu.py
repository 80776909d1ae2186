"""train_step_mfu: the train step's model FLOPs (counts/model_flops.py) a
second over the window (profiler off), as a share of the H100's dense bf16
peak, in %."""

from bench_torch.counts import peaks


def read(layer):
    if not layer.get("seconds_off") or "flops_per_step" not in layer:
        return None
    rate = layer["flops_per_step"] * layer["steps_off"] / layer[
        "seconds_off"]
    return 100.0 * rate / peaks.MFU_PEAK
