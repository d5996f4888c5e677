"""The device trace of a ``--trace 1`` run, by ``torch.profiler``.

The profiler traces the card through CUPTI over the whole measured
window; its events carry wall-clock nanoseconds (``time.time_ns``), so
the harness's own spans around each simulation (``Spans``), taken on the
same clock, name what the host was doing in each gap of the card.
Reading gives:

- ``busy_s``: the union of the card's kernels, copies and sets;
- ``kernels``: each kernel's durations in seconds, by name (the name
  before its argument list);
- ``device_ops``: the ten names that took the most card time;
- ``idle_gaps``: the ten longest gaps between card activity, each named
  by the harness span that covers most of it.
"""

from __future__ import annotations

import time
from collections import defaultdict


def kernel_name(name: str) -> str:
    """A profiler's kernel name without its return type, namespace and
    arguments: ``void (anonymous namespace)::draw_flags_kernel(...)`` ->
    ``draw_flags_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0].split("<")[0].strip()


class Spans:
    """The harness's own spans, on the profiler's clock."""

    def __init__(self) -> None:
        self.spans = []  # (name, start ns, end ns)

    def add(self, name: str, start_ns: int) -> float:
        """Record span ``name`` from ``start_ns`` to now; its seconds."""
        end = time.time_ns()
        self.spans.append((name, start_ns, end))
        return (end - start_ns) / 1e9

    def name_of(self, a: int, b: int) -> str:
        best, most = "harness", 0
        for name, s, e in self.spans:
            cover = min(b, e) - max(a, s)
            if cover > most:
                best, most = name, cover
        return best


class Trace:
    """Start before the window, stop after its last synchronize."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.start_ns = self.stop_ns = 0

    def start(self) -> None:
        self._prof.start()
        self.start_ns = time.time_ns()

    def stop(self) -> None:
        self.stop_ns = time.time_ns()
        self._prof.stop()

    def device_events(self) -> list:
        """(name, start ns, end ns) of every card activity in the window."""
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out

    def read(self, spans: Spans) -> dict:
        events = self.device_events()
        a, b = self.start_ns, self.stop_ns
        kernels = defaultdict(list)
        by_name = defaultdict(float)
        for name, s, e in events:
            short = kernel_name(name)
            if not short.startswith(("Memcpy", "Memset")):
                kernels[short].append((e - s) / 1e9)
            by_name[short] += (e - s) / 1e9
        busy = 0
        gaps = []
        cursor = a
        for _, s, e in sorted(events, key=lambda x: x[1]):
            s, e = max(s, a), min(e, b)
            if e <= s:
                continue
            if s > cursor:
                gaps.append((cursor, s))
            busy += e - max(s, cursor) if e > cursor else 0
            cursor = max(cursor, e)
        if b > cursor:
            gaps.append((cursor, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        return {
            "window_s": (b - a) / 1e9,
            "busy_s": busy / 1e9,
            "kernels": dict(kernels),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[spans.name_of(s, e), (e - s) / 1e9]
                          for s, e in gaps[:10]],
        }
