"""Per-stage timing and profiling (counterpart of
``pyqsm_tpu/utils/timing.py``): a context-manager timer whose stages end
with ``torch.cuda.synchronize()`` when the process has used the card, so
that a stage's time includes its device work, and a ``torch.profiler``
trace hook."""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Any, Iterator

import torch

log = logging.getLogger("pyqsm_tpu_torch.calc")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulates named stage timings."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None) -> Iterator[None]:
        """Time the block. ``sync`` (the stage's results, kept for the JAX
        package's signature) needs no blocking of its own: the card's queue
        is drained at the end of every stage."""
        del sync
        t0 = time.perf_counter()
        yield
        _sync()
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        log.debug("stage %-24s %.4fs", name, dt)

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"{k:<28} {v:8.4f}s  {100 * v / max(total, 1e-12):5.1f}%"
                 for k, v in self.stages.items()]
        lines.append(f"{'TOTAL':<28} {total:8.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def stage_timer(name: str, result_holder: dict | None = None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[name] = dt
    log.info("%s: %.4fs", name, dt)


@contextlib.contextmanager
def profile_trace(logdir: str | None = None) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (the card's activity too when
    there is one); the Chrome trace is written to ``logdir/trace.json``
    (default: ``pyqsm_trace`` in the temporary directory)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "pyqsm_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
