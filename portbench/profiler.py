"""Reading a ``torch.profiler`` trace of the card: the device's busy time,
the device time inside each ``record_function`` range, the device
operations that took most time, and the longest idle stretches by what the
host was doing.

A range's device time is the time in which some device operation ran
inside the range's device-side spans (the profiler's GPU annotations:
from the first to the last kernel the range launched, graph replays'
kernels included), so idle stretches inside a span do not count.  The
operations' links to host operators are not used: K1 launches through
``ctypes`` and its kernels link to no host operator, where ``chip_smoke.py``'s
``profile_totals`` (which reads those links) sees none of their time.
"""
from __future__ import annotations

import bisect
import contextlib
import heapq
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

# host events torch's own processing leaves out (``_filter_name``)
SKIPPED = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
           "profiler::_record_function_enter_new", "profiler::_record_function_exit",
           "aten::is_leaf", "aten::output_nr", "aten::_version"}
WINDOW_RANGE = "portbench.window"
TOP = 10      # entries of each breakdown list


@contextlib.contextmanager
def traced():
    """A profiler of host and device activity around the block."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


class Trace:
    """One profile's events, in ns on the trace's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.ops: List[Tuple[int, int, str]] = []          # device operations
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)   # device-side ranges
        self.host: List[Tuple[int, int, str]] = []         # host events
        self.window = None
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if name in SKIPPED:
                continue
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == DeviceType.CPU:
                if name == WINDOW_RANGE:
                    self.window = (start, end)
                elif not e.is_async():
                    self.host.append((start, end, name))
            elif e.is_user_annotation():
                self.spans[name].append((start, end))
            elif end > start:
                self.ops.append((start, end, name))
        self.busy = _merge((s, e) for s, e, _ in self.ops)
        self._starts = [s for s, _ in self.busy]

    def busy_ns(self, lo: int, hi: int) -> int:
        """Time in [lo, hi) in which some device operation ran."""
        total = 0
        i = max(bisect.bisect_right(self._starts, lo) - 1, 0)
        while i < len(self.busy) and self.busy[i][0] < hi:
            s, e = self.busy[i]
            total += max(0, min(e, hi) - max(s, lo))
            i += 1
        return total

    def range_ms(self, name: str) -> Tuple[float, int]:
        """(device ms inside range ``name``'s spans, its spans)."""
        spans = _merge(self.spans.get(name, []))
        return sum(self.busy_ns(s, e) for s, e in spans) / 1e6, len(self.spans.get(name, []))

    def ranges(self) -> Dict[str, Tuple[float, int]]:
        return {name: self.range_ms(name) for name in self.spans}

    def timeline(self) -> Dict:
        """The window range's picture: busy seconds, the window's length,
        the device operations that took most time, and the idle
        stretches summed by the innermost host event at their middle."""
        if self.window is None:
            raise RuntimeError(f"no {WINDOW_RANGE!r} range in the trace")
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy:
            if e <= lo or s >= hi:
                continue
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        ops = Counter()
        for s, e, n in self.ops:
            if e > lo and s < hi:
                ops[n] += (min(e, hi) - max(s, lo)) / 1e9
        host = sorted(self.host)
        by_host, heap, i = Counter(), [], 0
        for mid, length in sorted(((a + b) // 2, b - a) for a, b in gaps):
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            by_host[heap[0][2] if heap else "(no host event)"] += length / 1e9
        return {"busy_s": self.busy_ns(lo, hi) / 1e9, "window_s": (hi - lo) / 1e9,
                "device_ops": [[n[:160], s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n[:160], s] for n, s in by_host.most_common(TOP)]}


def _merge(intervals) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def windowed(fn):
    """``fn()`` inside the window's ``record_function`` range."""
    from torch.profiler import record_function

    with record_function(WINDOW_RANGE):
        return fn()


def range_ms(ranges: Dict[str, Tuple[float, int]], name: str) -> Tuple[float, int]:
    """(device ms, spans) of range ``name`` in a ``Trace.ranges()``, or
    (0, 0) where the range ran nothing on the device."""
    return ranges.get(name, (0.0, 0))
