"""The device trace of a run's traced part, read from `torch.profiler`.

`Recorder` runs the profiler over CPU and CUDA activity; the traced part
of the window lies inside a `flipbench.traced` annotation. `read_trace`
parses the profiler's Chrome trace into device operations and host spans
and keeps those inside that annotation. `DeviceTrace` then answers what
the per-layer readers ask: busy time (the union of device operations),
operations counted and timed by name, and the idle gaps named by what the
host was doing (the innermost host span over each gap's middle).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import tempfile
from collections import defaultdict

import numpy as np

WINDOW = "flipbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceTrace:
    """Events of the traced window, times in seconds from its start."""
    window_s: float
    device: list            # (start, end, name), sorted by start
    host: list              # (start, end, name)

    def busy_intervals(self) -> list:
        """The union of the device operations, clipped to the window."""
        merged = []
        for s, e, _ in self.device:
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return float(sum(e - s for s, e in self.busy_intervals()))

    @property
    def ops(self) -> int:
        return len(self.device)

    def seconds_of(self, substring: str) -> float:
        """Device seconds of the operations whose name holds `substring`."""
        return float(sum(e - s for s, e, name in self.device
                         if substring in name))

    def top_ops(self, k: int = 10) -> list:
        total = defaultdict(float)
        for s, e, name in self.device:
            total[name] += e - s
        return sorted(([n, t] for n, t in total.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The window's idle time summed by the innermost host span that
        covers each gap's middle ('no host span' where none does), the
        largest `k`."""
        gaps, t = [], 0.0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window_s > t:
            gaps.append((t, self.window_s))
        host = sorted(self.host)
        total = defaultdict(float)
        heap, j = [], 0
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = 0.5 * (g0 + g1)
            while j < len(host) and host[j][0] <= mid:
                s, e, name = host[j]
                heapq.heappush(heap, (e - s, e, name))
                j += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            total[heap[0][2] if heap else "no host span"] += g1 - g0
        return sorted(([n, t] for n, t in total.items()),
                      key=lambda x: -x[1])[:k]


def parse_events(events: list) -> DeviceTrace | None:
    """A `DeviceTrace` from Chrome-trace events; None without a window."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation" and "dur" in e]
    if not win:
        return None
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        if not t0 <= s <= t1:
            continue
        rec = ((s - t0) * 1e-6, (s + float(e["dur"]) - t0) * 1e-6,
               str(e.get("name", "")))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(rec)
        elif cat in HOST_CATS and rec[2] != WINDOW:
            host.append(rec)
    device.sort()
    return DeviceTrace(window_s=(t1 - t0) * 1e-6, device=device, host=host)


class Recorder:
    """The profiler over a run's traced part. `warm` (in set-up) runs
    one empty profiling cycle, so the profiler's own first start-up falls
    in set-up; `start` and `stop` bracket the profiled stretch, and
    `window()` marks the traced window inside it (`flipbench.traced`)."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity
        self.acts = [ProfilerActivity.CPU]
        if cuda:
            self.acts.append(ProfilerActivity.CUDA)
        self.prof = None
        self.on = False

    def warm(self):
        self.start()
        self.stop()

    def start(self):
        from torch.profiler import profile
        self.prof = profile(activities=self.acts)
        self.prof.start()
        self.on = True

    def stop(self):
        if self.on:
            self.prof.stop()
            self.on = False

    @staticmethod
    def window():
        from torch.profiler import record_function
        return record_function(WINDOW)

    def read(self) -> DeviceTrace | None:
        """Export the trace to a temporary file, parse it, delete it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return parse_events(events)


def span(name: str):
    """A host span in the profiler's trace."""
    from torch.profiler import record_function
    return record_function(name)


def percentile(values, q: float) -> float | None:
    """The q-th percentile of every value by nearest rank (the smallest
    value with at least q% of the values at or below it); an inf value,
    a request that never came, stays inf. None for no values."""
    arr = np.sort(np.asarray(values, dtype=np.float64))
    if arr.size == 0:
        return None
    rank = int(np.ceil(q / 100.0 * arr.size))
    return float(arr[min(max(rank, 1), arr.size) - 1])
