"""A torch.profiler window over whole batches, reduced to what the
per-layer metrics read: the device operations with their intervals, the
host's operations beside them, and the traced span.

The events are read from the profiler's kineto results directly, without
building its per-event Python tree, which takes minutes for a batch of a
few hundred thousand kernels.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch



def _interval_ns(ev):
    """(start, end) of a kineto event in ns (older PyTorch: in us only)."""
    if hasattr(ev, "start_ns"):
        s = ev.start_ns()
        return s, s + ev.duration_ns()
    s = ev.start_us() * 1000
    return s, s + ev.duration_us() * 1000


def _device_op_kind(name):
    """kernel, gpu_memcpy or gpu_memset, by the name CUPTI gives a device
    operation."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


@dataclass
class Trace:
    span_ns: tuple  # (start, end) of the traced window, on the events' clock
    ops: list  # (name, activity, start_ns, end_ns) of every device operation
    host: list  # (name, start_ns, end_ns) of the host's operations
    counters: dict = field(default_factory=dict)  # program counters, deltas over the window
    iters: int = 0  # lockstep iterations of the traced batches (each batch's largest)

    @property
    def kernels(self):
        return [o for o in self.ops if o[1] == "kernel"]

    def busy_ns(self):
        """Time in the span in which some device operation ran (the union
        of their intervals)."""
        lo, hi = self.span_ns
        busy, end = 0, lo
        for _, _, s, e in sorted(self.ops, key=lambda o: o[2]):
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def time_by_name(self, names):
        """Device ns of the kernels whose name holds one of `names`."""
        return sum(e - s for n, _, s, e in self.kernels if any(k in n for k in names))

    def top_ops(self, k=10):
        tot = {}
        for n, _, s, e in self.ops:
            tot[n] = tot.get(n, 0) + (e - s)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k=10):
        """Idle device time by what the host was doing: each gap between
        device operations is put under the innermost host operation that
        runs at its middle ("python" where none does)."""
        lo, hi = self.span_ns
        gaps, end = [], lo
        for _, _, s, e in sorted(self.ops, key=lambda o: o[2]):
            if s > end:
                gaps.append((end, min(s, hi)))
            end = max(end, e)
        if end < hi:
            gaps.append((end, hi))
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        starts = [h[1] for h in host]
        tot = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            label = "python"
            # the innermost enclosing host op starts last among those that
            # enclose the middle; look back over the few that start before it
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 64, -1), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
            tot[label] = tot.get(label, 0) + (g1 - g0)
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]


class Window:
    """Profile the code inside `with Window() as w:`; w.trace is set on
    exit. Only the device is traced (CUDA activity: kernels, copies, sets,
    and the runtime calls that launched them), which keeps the profiler's
    cost on the host small; the span is read on the host clock the events
    carry (epoch ns), from after a synchronize on entry to after one on
    exit, so every device operation of the code lies inside it."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

        acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._t0 = time.time_ns()
        self.trace = None
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        span = (self._t0, time.time_ns())
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        ops, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.profiler.kineto_results.events():
            if ev.is_user_annotation():
                continue
            name, s, e = ev.name(), *_interval_ns(ev)
            if ev.device_type() == cuda:
                ops.append((name, _device_op_kind(name), s, e))
            else:
                host.append((name, s, e))
        self.trace = Trace(span_ns=span, ops=ops, host=host)
        return False
