"""train.rn_pool_roofline_share: over the profiled stretch, the summed
least time of the relation-network pool's forward calls
(counts/vizdoom_full.py: max(the two FC GEMMs' FLOPs / the float32 peak,
bytes / HBM bandwidth), a call's pair rows from the `encoder.rn_rows`
counter) over the device time of the kernels launched inside the
program's `d2p.encoder.rn` ranges (the pairs, both FCs with their batch
norms, the mean), in %. The ranges cover the forward only; the backward's
kernels show in `device_ops`."""

from bench_torch.counts import vizdoom_full


def read(layer):
    calls, rows = layer.get("rn_calls"), layer.get("rn_count")
    device_s = layer.get("rn_device_s")
    if not calls or not rows or not device_s:
        return None
    least = calls * vizdoom_full.rn_pool_least_time(
        rows / calls, layer["units"], layer["batch_size"], layer["num_k"])
    return 100.0 * least / device_s
