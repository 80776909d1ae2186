"""train.frame_encoder_roofline_share: over the profiled stretch, the
summed least time of the frame CNN's forward calls (counts/vizdoom_full.py:
max(conv FLOPs / the float32 peak, bytes / HBM bandwidth), a call's frames
from the `encoder.frames` counter) over the device time of the kernels
launched inside the program's `d2p.encoder.frames` ranges, in %. The
ranges cover the forward only; the backward's kernels show in
`device_ops`."""

from bench_torch.counts import vizdoom_full


def read(layer):
    calls, frames = layer.get("frames_calls"), layer.get("frames_count")
    device_s = layer.get("frames_device_s")
    if not calls or not frames or not device_s:
        return None
    least = calls * vizdoom_full.frame_encoder_least_time(
        frames / calls, *layer["frame_shape"])
    return 100.0 * least / device_s
