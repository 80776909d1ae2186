"""The trace reduction on synthetic profiler events, with and without the
activity_type attribute, which torch 2.11's events lack (the H100
machine's torch) and later versions have."""

import pytest

from bench_torch.harness import trace


class Ev:
    def __init__(self, name, start, dur, kind, device=False, corr=0, tid=1,
                 annotation=False):
        self._name, self._s, self._d = name, start, dur
        self._dev, self._corr, self._tid = device, corr, tid
        self._annotation = annotation
        if kind is not None:
            self.activity_type = lambda: kind

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._annotation


def events(with_kinds):
    k = (lambda s: s) if with_kinds else (lambda s: None)
    return [
        Ev("step", 0, 1000, k("user_annotation"), annotation=True),
        Ev("bench.lstm_step", 100, 200, k("user_annotation"),
           annotation=True),
        Ev("cudaLaunchKernelExC", 150, 20, k("cuda_runtime"), corr=7),
        Ev("cudaLaunchKernel", 400, 20, k("cuda_runtime"), corr=8),
        Ev("aten::item", 600, 300, k("cpu_op")),
        Ev("fused_lstm", 200, 100, k("kernel"), device=True, corr=7),
        Ev("bench.lstm_step", 200, 100, k("gpu_user_annotation"),
           device=True, annotation=True),
        Ev("gemm", 450, 50, k("kernel"), device=True, corr=8),
        Ev("Memcpy DtoH", 480, 40, k("gpu_memcpy"), device=True),
    ]


@pytest.mark.parametrize("with_kinds", [True, False])
def test_reduce(with_kinds):
    r = trace.reduce_events(events(with_kinds), "bench.lstm_step")
    # busy: [200, 300) and [450, 520); window [0, 1000)
    assert r["busy_s"] == pytest.approx(170e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["range_device_s"] == pytest.approx(100e-9)
    assert dict(r["device_ops"]) == pytest.approx(
        {"fused_lstm": 100e-9, "gemm": 50e-9, "Memcpy DtoH": 40e-9})
    # gaps [0,200) in the lstm range, [300,450) in "step", [520,1000)
    # mostly in aten::item
    idle = dict(r["idle_gaps"])
    assert idle["bench.lstm_step"] == pytest.approx(200e-9)
    assert idle["step"] == pytest.approx(150e-9)
    assert idle["aten::item"] == pytest.approx(480e-9)
    # one traced step of 1000 ns against an unprofiled step of 500 ns
    assert trace.idle_share(dict(r, traced_steps=1, step_s=500e-9)) == (
        pytest.approx(66.0))
    assert trace.idle_share({}) is None
