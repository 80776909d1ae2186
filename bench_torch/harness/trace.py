"""Device trace of a stretch of the run, from torch.profiler (CUPTI).

`Trace` profiles the CPU and the card over a stretch of steps and reduces
the raw events to what the per-layer metrics read:

  * busy_s: the union of kernel, memcpy and memset intervals;
  * window_s: the profiled stretch, from its first host op to the end of
    its last device op;
  * range_device_s: the device time of the kernels launched inside the
    `record_function` ranges of one name (their launches matched to the
    kernels by correlation id);
  * device_ops: the kernels' summed seconds, by name;
  * idle_gaps: the seconds the device stood idle, by the host op that was
    running (the innermost one open at each gap's middle).
"""

import bisect
import collections
import sys

import torch

DEVICE_KINDS = ("kernel", "memcpy", "memset")


class Trace:
    def __init__(self, device):
        self.device = device
        self.prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def reduce(self, range_name="bench.lstm_step"):
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             range_name)


def _flag(e, name):
    """An event attribute that some torch versions lack (torch 2.11's
    _KinetoEvent has no activity_type)."""
    attr = getattr(e, name, None)
    return attr() if attr is not None else None


def _kind(e, annotations):
    """kernel, memcpy, memset or device_other for device events; runtime
    (CUDA runtime and driver calls), range (user annotations) or op for
    host events. Without activity_type, by device and name."""
    device = "cuda" in str(e.device_type()).lower()
    act = str(_flag(e, "activity_type") or "").lower()
    name = e.name()
    if device:
        if act:
            return next((k for k in DEVICE_KINDS if k in act),
                        "device_other")
        if _flag(e, "is_user_annotation") or name in annotations:
            return "device_other"
        low = name.lower()
        return next((k for k in ("memcpy", "memset") if low.startswith(k)),
                    "kernel")
    if act:
        if "runtime" in act or "driver" in act:
            return "runtime"
        return ("range" if "user_annotation" in act else
                "op" if "cpu_op" in act else "other")
    if _flag(e, "is_user_annotation"):
        return "range"
    if name.startswith("cu") and "::" not in name:
        return "runtime"
    return "op"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, times):
    """For each time, the name of the innermost host event open at it:
    per thread the latest-started event that covers it, across threads
    the latest start."""
    by_thread = collections.defaultdict(list)
    for s, e, name, tid in host:
        by_thread[tid].append((s, e, name))
    best = [(-1, "idle host")] * len(times)
    order = sorted(range(len(times)), key=lambda i: times[i])
    for events in by_thread.values():
        events.sort()
        stack, j = [], 0
        for i in order:
            t = times[i]
            while j < len(events) and events[j][0] <= t:
                stack.append(events[j])
                j += 1
            stack = [ev for ev in stack if ev[1] >= t]
            if stack and stack[-1][0] > best[i][0]:
                best[i] = (stack[-1][0], stack[-1][2])
    return [name for _, name in best]


def reduce_events(events, range_name):
    device, ranges, runtime, host = [], [], [], []
    counts = collections.Counter()
    annotations = {e.name() for e in events
                   if "cuda" not in str(e.device_type()).lower()
                   and _flag(e, "is_user_annotation")}
    annotations.add(range_name)
    for e in events:
        kind = _kind(e, annotations)
        counts[kind] += 1
        s = e.start_ns()
        end = s + e.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((s, end, e.name(), e.correlation_id(),
                           e.linked_correlation_id(), kind))
        elif kind == "runtime":
            runtime.append((s, end, e.start_thread_id(), e.correlation_id()))
            host.append((s, end, e.name(), e.start_thread_id()))
        elif kind in ("range", "op"):
            host.append((s, end, e.name(), e.start_thread_id()))
            if kind == "range" and e.name() == range_name:
                ranges.append((s, end, e.start_thread_id()))
    if not device:
        print(f"trace: no device events; kinds {dict(counts)}",
              file=sys.stderr)
        return None
    busy = _merge([(s, e) for s, e, *_ in device])
    t0 = min([s for s, *_ in host] + [busy[0][0]])
    t1 = max(busy[-1][1], max((e for _, e, *_ in host), default=0))
    busy_ns = sum(e - s for s, e in busy)

    # the kernels launched inside the ranges
    ranges.sort()
    starts = [r[0] for r in ranges]
    marked = set()
    for s, e, tid, corr in runtime:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and ranges[i][1] >= e and ranges[i][2] == tid:
            marked.add(corr)
    range_ns = sum(e - s for s, e, _, corr, linked, kind in device
                   if kind == "kernel" and (corr in marked or
                                            linked in marked))
    by_name = collections.Counter()
    for s, e, name, *_ in device:
        by_name[name] += e - s
    gaps = [(a[1], b[0]) for a, b in zip([[t0, t0]] + busy, busy + [[t1, t1]])
            if b[0] > a[1]]
    names = _innermost(host, [(a + b) / 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), name in zip(gaps, names):
        idle[name] += b - a
    print(f"trace: {len(device)} device events, {len(ranges)} "
          f"'{range_name}' ranges, {len(marked)} launches in them; "
          f"kinds {dict(counts)}", file=sys.stderr)
    return {
        "busy_s": busy_ns / 1e9, "window_s": (t1 - t0) / 1e9,
        "range_device_s": range_ns / 1e9, "ranges": len(ranges),
        "device_ops": [[n, v / 1e9] for n, v in by_name.most_common(10)],
        "idle_gaps": [[n, v / 1e9] for n, v in idle.most_common(10)],
    }


def idle_share(layer):
    """The device's idle share of an unprofiled step, in %: 1 - (busy
    seconds a traced step) / (seconds a step of the profiler-off window).
    The profiler's host work lengthens a traced step, so its own stretch
    would overstate idling; None without a trace."""
    if not layer.get("busy_s") or not layer.get("step_s"):
        return None
    return 100.0 * (1.0 - layer["busy_s"] / layer["traced_steps"]
                    / layer["step_s"])
