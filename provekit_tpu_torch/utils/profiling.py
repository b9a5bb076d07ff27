"""Span tree: wall time per named pipeline stage.

Port of the ``span`` part of ``provekit_tpu/utils/profiling.py`` and its
``report``, without the device-memory column.  Device work is asynchronous,
so a span measures dispatch time unless the tree is given a ``sync``
callable (for instance ``torch.cuda.synchronize``), which then runs at every
span exit so that each span holds its own device time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start: float = 0.0
    elapsed: float = 0.0
    children: list = field(default_factory=list)


class SpanTree:
    def __init__(self, sync=None):
        self.root = Span("root")
        self.stack = [self.root]
        self.sync = sync

    @contextmanager
    def span(self, name: str):
        s = Span(name, start=time.perf_counter())
        self.stack[-1].children.append(s)
        self.stack.append(s)
        try:
            yield s
        finally:
            if self.sync is not None:
                self.sync()
            s.elapsed = time.perf_counter() - s.start
            self.stack.pop()

    def report(self) -> str:
        """The tree drawn with box characters, one span a line with its
        wall time."""
        lines = []

        def human(x: float) -> str:
            for unit, scale in (("s", 1), ("ms", 1e-3), ("us", 1e-6)):
                if x >= scale:
                    return f"{x / scale:7.2f} {unit}"
            return f"{x * 1e9:7.2f} ns"

        def walk(span, prefix, is_last):
            branch = "└─" if is_last else "├─"
            lines.append(f"{prefix}{branch} {span.name:<28}"
                         f" {human(span.elapsed)}")
            ext = "   " if is_last else "│  "
            for i, child in enumerate(span.children):
                walk(child, prefix + ext, i == len(span.children) - 1)

        for i, child in enumerate(self.root.children):
            walk(child, "", i == len(self.root.children) - 1)
        return "\n".join(lines)


GLOBAL = SpanTree()
span = GLOBAL.span


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream over
    ``reps`` runs after one warm-up run, timed with CUDA events."""
    import statistics

    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int = 20) -> float:
    """Milliseconds a launch of ``reps`` launches queued back to back
    between two CUDA events, after one warm-up run: the card does not idle
    while the host prepares the next launch, as it can before a single
    timed launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, windows: int = 3) -> list[str]:
    """The names of the device kernels that torch.profiler records while
    ``fn()`` runs, one a launch, in the order they started: of ``windows``
    windows of CUDA activity, the one that recorded the most.

    On the H100 a window has now and then lost one kernel's record (every
    launch counted by its wrapper, the work's time unchanged), so each
    window also leaves the card idle for 50 ms before ``fn()`` and after
    it, and a lost record can only make a window shorter."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    best = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if len(events) > len(best):
            best = [e.name for e in events]
    return best
