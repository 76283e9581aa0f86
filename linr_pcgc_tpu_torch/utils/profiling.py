"""Named span timers and trace capture.

Port of linr_pcgc_tpu/utils/profiling.py: the same ``Timer`` and ``timed``;
``trace_context`` captures a ``torch.profiler`` trace (host and, where
there is a card, device activity) and writes it as a Chrome trace into the
directory it is given (open it in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict

import torch


@dataclasses.dataclass
class Timer:
    """Accumulating named span timer."""

    totals: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def span(self, name: str):
        st = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - st
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / max(1, self.counts[name]),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def trace_context(trace_dir: str | None):
    """Capture a torch.profiler trace of the block into
    ``trace_dir``/trace.json (device activity too where CUDA is available)
    when a directory is given; a no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, log=print):
    st = time.perf_counter()
    yield
    log(f"{label}: {time.perf_counter() - st:.4f}s")
