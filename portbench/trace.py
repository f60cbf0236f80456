"""The traced run's profiler window, reduced in memory.

``torch.profiler`` records the host's operators and the card's kernels,
copies and sets (CUPTI) while a bounded number of requests run, each inside
a ``portbench.request`` span of the benchmark's own.  Nothing is written to
disk: the raw events are read once from the profiler's results and reduced
to what the per-layer readers need:

* ``spans``: per traced request, the host span's start and end and the
  first start and last end of device activity inside it (ns);
* ``kernels``: per device operation name, launches and summed ns;
* ``busy_ns`` / ``window_ns``: the union of device activity over the window
  that runs from the first span's start to the last span's end;
* ``gaps``: the idle time of that window by what the host was doing when
  the device fell idle (the innermost host operator or runtime call that
  covers the middle of the gap, else ``python``).
"""
from __future__ import annotations

import bisect
import contextlib

SPAN = "portbench.request"
DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITY = ("cpu_op", "cuda_runtime", "cuda_driver")


class Trace:
    """Reduced events of one traced window."""

    def __init__(self, spans, device, host):
        device.sort()
        self.kernels = {}
        for s, e, name in device:
            k = self.kernels.setdefault(name, [0, 0])
            k[0] += 1
            k[1] += e - s
        self.spans = []
        starts = [d[0] for d in device]
        for s, e in sorted(spans):
            i = bisect.bisect_left(starts, s)
            inside = [d for d in device[i:bisect.bisect_right(starts, e)] if d[1] <= e]
            self.spans.append(dict(
                start=s, end=e,
                first_device=inside[0][0] if inside else None,
                last_device=max(d[1] for d in inside) if inside else None))
        if not self.spans:
            self.window_ns, self.busy_ns, self.gaps = 0, 0, {}
            return
        w0 = self.spans[0]["start"]
        w1 = max(sp["end"] for sp in self.spans)
        self.window_ns = w1 - w0
        merged = []
        for s, e, _ in device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_ns = sum(e - s for s, e in merged)
        idle, t = [], w0
        for s, e in merged:
            if s > t:
                idle.append((t, s))
            t = max(t, e)
        if w1 > t:
            idle.append((t, w1))
        host.sort()
        hstarts = [h[0] for h in host]
        self.gaps = {}
        for a, b in idle:
            mid = (a + b) // 2
            label = "python"
            # the innermost host event covering the middle of the gap: of
            # nested events the inner one starts last
            i = bisect.bisect_right(hstarts, mid)
            for h in host[max(0, i - 256):i][::-1]:
                if h[1] >= mid:
                    label = h[2]
                    break
            self.gaps[label] = self.gaps.get(label, 0) + (b - a)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[name, ns / 1e9] for name, (_, ns) in ops],
                "idle_gaps": [[name, ns / 1e9] for name, ns in gaps]}


class Recorder:
    """Profiles the requests run inside :meth:`window`; each request is
    wrapped in :meth:`request`.  ``result`` is the reduced :class:`Trace`."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.result = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield self
            if self.cuda:
                torch.cuda.synchronize()
        self.result = reduce_events(prof.profiler.kineto_results.events())

    @staticmethod
    def request():
        from torch.profiler import record_function

        return record_function(SPAN)


def activity(ev) -> str:
    """The kineto activity type of a profiler event.  Older torch builds
    lack ``activity_type``: there a device event is a kernel, copy or set
    unless it is an annotation (the GPU side of a ``record_function``), and
    a host event is an operator unless it is a user annotation."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind()
    user = getattr(ev, "is_user_annotation", lambda: False)() or ev.name() == SPAN
    if str(ev.device_type()).endswith("CUDA"):
        return "gpu_user_annotation" if user else "kernel"
    return "user_annotation" if user else "cpu_op"


def reduce_events(events) -> Trace:
    spans, device, host = [], [], []
    for ev in events:
        kind = activity(ev)
        if kind == "user_annotation" and ev.name() == SPAN:
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif kind in DEVICE_ACTIVITY:
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
        elif kind in HOST_ACTIVITY:
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
    return Trace(spans, device, host)
