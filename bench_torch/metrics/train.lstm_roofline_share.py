"""train.lstm_roofline_share: the summed least time of the profiled
stretch's forward LSTM-step calls (counts/lstm.py) over the device time of
the kernels those calls launched, in %."""

from bench_torch.counts import lstm


def read(layer):
    calls, device_s = layer.get("lstm_calls"), layer.get("range_device_s")
    if not calls or not device_s:
        return None
    least = sum(lstm.least_time(*call) for call in calls)
    return 100.0 * least / device_s
