"""The traced window: ``torch.profiler`` over the window, reduced to what
the per-layer metrics read.

The method of ``chip_smoke.py``'s ``profile_build`` and ``device_ms``
(device time by kernel and the busy share from the profiler's device
events, the host time of the program's ranges from its CPU events),
rewritten here. What it adds: each device operation is tied to the host
range in which it was launched, by the correlation id that the profiler
gives a launch on the host and the kernel it starts on the card. The
program's kernels are launched through ``ctypes``, outside PyTorch's
operators, and are tied the same way, through the CUDA runtime's launch.

Every time is in the profiler's clock, in nanoseconds; the window is the
harness's own range ``bench.window``.
"""
import bisect

import torch

WINDOW = 'bench.window'
#: the host calls of the CUDA runtime and driver that start device work
LAUNCH_PREFIXES = ('cuda', 'cu')


def _times(e):
    """(start, end) of a profiler event, in nanoseconds."""
    if hasattr(e, 'start_ns'):
        return e.start_ns(), e.end_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


def _is_annotation(e):
    """Whether a host event is a ``record_function`` range."""
    if hasattr(e, 'is_user_annotation'):
        return e.is_user_annotation()
    name = e.name()
    return '::' not in name and not name.startswith(LAUNCH_PREFIXES)


class Trace:
    """The reduced trace of one window.

    - ``ops``: device operations, (name, start, end, launch time or None);
    - ``ranges``: host ranges of ``record_function``, (name, start, end);
    - ``window``: (start, end) of the window.
    """

    def __init__(self, events):
        from torch.autograd import DeviceType
        launches = {}
        device, ranges = [], []
        for e in events:
            name = e.name()
            start, end = _times(e)
            if e.device_type() == DeviceType.CUDA:
                device.append((name, start, end, e.correlation_id()))
            elif _is_annotation(e):
                ranges.append((name, start, end))
            elif name.startswith(LAUNCH_PREFIXES):
                launches[e.correlation_id()] = start
        # the profiler marks each host range's span on the device too, under
        # the range's name: those are no device operations
        names = {r[0] for r in ranges}
        self.ops = [(n, s, t, launches.get(c)) for n, s, t, c in device
                    if n not in names]
        self.ops.sort(key=lambda o: o[1])
        self.ranges = sorted(ranges, key=lambda r: r[1])
        windows = [r for r in self.ranges if r[0] == WINDOW]
        self.window = (windows[0][1], windows[0][2]) if windows else (
            min((o[1] for o in self.ops), default=0),
            max((o[2] for o in self.ops), default=0))
        self.untied = sum(o[3] is None for o in self.ops)

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self):
        """Seconds of the window in which some device operation ran: the
        union of their intervals."""
        lo, hi = self.window
        busy, end = 0, lo
        for _, s, t, _ in self.ops:
            s, t = max(s, end), min(t, hi)
            if t > s:
                busy += t - s
                end = t
        return busy / 1e9

    def _spans(self, name):
        return [(s, t) for n, s, t in self.ranges if n == name]

    def device_s_in(self, name):
        """Device seconds of the operations launched inside the host ranges
        called ``name``."""
        spans = self._spans(name)
        starts = [s for s, _ in spans]
        total = 0
        for _, s, t, launch in self.ops:
            if launch is None:
                continue
            k = bisect.bisect_right(starts, launch) - 1
            if k >= 0 and launch <= spans[k][1]:
                total += t - s
        return total / 1e9

    def host_s_in(self, name):
        """Host seconds inside the ranges called ``name`` (their summed
        lengths)."""
        return sum(t - s for s, t in self._spans(name)) / 1e9

    def device_ops(self, top=10):
        """[[name, seconds], ...]: the device operations that took most
        time, summed by name."""
        by = {}
        for n, s, t, _ in self.ops:
            by[n] = by.get(n, 0) + (t - s)
        best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v / 1e9] for n, v in best]

    def idle_gaps(self, top=10):
        """[[name, seconds], ...]: the device's idle time in the window,
        summed by what the host was doing when the gap ended (the innermost
        range around the launch of the operation after it; 'no range' when
        none)."""
        lo, hi = self.window
        gaps = []
        end = lo
        for _, s, t, launch in self.ops + [(None, hi, hi, None)]:
            if s > end and end < hi:
                gaps.append((launch if launch is not None else end,
                             min(s, hi) - end))
            end = max(end, t)
        gaps.sort()
        ranges = [r for r in self.ranges if r[0] != WINDOW]
        by, stack, k = {}, [], 0
        for at, gap in gaps:
            # a sweep over the ranges, which nest: the stack holds those
            # open at ``at``, the innermost last
            while k < len(ranges) and ranges[k][1] <= at:
                while stack and stack[-1][2] < ranges[k][1]:
                    stack.pop()
                stack.append(ranges[k])
                k += 1
            while stack and stack[-1][2] < at:
                stack.pop()
            name = stack[-1][0] if stack else 'no range'
            by[name] = by.get(name, 0) + gap
        best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in best]


class Tracer:
    """``with Tracer() as tr:`` profiles the block; ``tr.trace`` is the
    :class:`Trace` after it."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.trace = Trace(self._prof.profiler.kineto_results.events())
        del self._prof
        return False
