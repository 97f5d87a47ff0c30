"""Device trace of a slice of the window, from `torch.profiler`.

`Tracer` profiles the host and the card around a slice of the window
(marked by a ``perfbench.window`` span on the host), and `Trace` reduces
what the profiler recorded: each kernel's name and interval on the
card, the device's busy time (the union of kernel intervals, so
overlapping kernels count once), the slice's length, the kernels that
took the most time and the longest idle gaps by what the host was doing
when they began.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

MARK = "perfbench.window"


@dataclasses.dataclass
class Trace:
    kernels: list        # (name, start_us, end_us) on the device
    host_ops: list       # (name, start_us, end_us) on the host
    window: tuple        # (start_us, end_us) of the traced slice

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list:
        out = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.window[0]), min(e, self.window[1])
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self, pattern: str) -> float:
        """Seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for n, s, e in self.kernels:
            by[short_name(n)] += (e - s) * 1e-6
        return [[n, v] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time between kernels, summed by the innermost host
        operation running where each gap begins."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        ops = sorted((o for o in self.host_ops if o[0] != MARK),
                     key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by = collections.Counter()
        for s, e in gaps:
            name = "host idle"
            # the latest-started operation still running at s (looked for
            # among the last 4096 started, which holds the innermost one)
            i = bisect.bisect_right(starts, s)
            for j in range(i - 1, max(i - 4097, -1), -1):
                if ops[j][2] > s:
                    name = ops[j][0]
                    break
            by[short_name(name)] += (e - s) * 1e-6
        return [[n, v] for n, v in by.most_common(top)]


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and argument list, at most
    ``width`` characters."""
    n = name.strip()
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i] if i > 0 else n
                break
    if n.startswith("void "):
        n = n[5:]
    return n[:width].strip()


class Tracer:
    """``with Tracer(on) as tr: ...`` profiles the block when ``on``;
    ``tr.result()`` then reduces what the profiler recorded to a `Trace`
    (None when off, or when the profiler saw no device activity). The
    reduction takes seconds, so a caller makes it after its window."""

    def __init__(self, on: bool, sync):
        self.on, self.sync, self._prof = on, sync, None

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self.sync()
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark = torch.profiler.record_function(MARK)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self.sync()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def result(self) -> Trace | None:
        return None if self._prof is None else reduce(self._prof)


def _events(prof):
    """(name, on the device, start us, end us) of every recorded event,
    from the profiler's raw records (building its event tree takes
    minutes for a job of ~10^5 launches)."""
    from torch.autograd import DeviceType
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-3
        yield (e.name(), e.device_type() == DeviceType.CUDA, start,
               start + e.duration_ns() * 1e-3)


def reduce(prof) -> Trace | None:
    kernels, host, window = [], [], None
    for name, on_device, start, end in _events(prof):
        if on_device:
            # a span's shadow on the device timeline is no device work
            if name != MARK:
                kernels.append((name, start, end))
        else:
            host.append((name, start, end))
            if name == MARK:
                window = (start, end)
    if not kernels or window is None:
        return None
    return Trace(kernels=kernels, host_ops=host, window=window)
