"""Experiment tracking and profiling hooks.

``MetricsLogger`` writes one JSON line a call to ``train_log.jsonl``, as the
JAX package's does, and to wandb when ``report_to="wandb"`` and the package
is there (imported only then).  ``maybe_profile`` traces a window of steps
with ``torch.profiler`` (CPU and, where present, CUDA activities) into a
Chrome trace under ``output_dir/profile``.  ``StepTimer`` times steps on
the host clock, skipping the first few; where the work runs on a CUDA
device it synchronizes the device at each tick and tock, so a step's time
is its device work's and not its launches'.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Optional

import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "none", run_name=None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "train_log.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if report_to == "wandb":
            try:
                import wandb

                self._wandb = wandb.init(project="qlora_tpu", name=run_name, dir=output_dir)
            except Exception as e:  # wandb optional, offline-safe
                logger.warning("wandb unavailable (%s); jsonl only", e)

    def log(self, metrics: dict, step: Optional[int] = None):
        row = {"ts": time.time(), **({"step": step} if step is not None else {}), **metrics}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


@contextlib.contextmanager
def maybe_profile(output_dir: str, enabled: bool):
    """``torch.profiler`` over the block when `enabled`; yields the profiler
    (or None), whose ``key_averages()`` the caller may read after the block.
    The Chrome trace goes to ``output_dir/profile/trace.json``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    trace_dir = os.path.join(output_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    logger.info("profile trace written to %s", trace_dir)


class StepTimer:
    """Per-step wall timing with warmup-aware averages: the first
    `skip_first` steps are timed but left out of ``times`` and ``mean``.
    With a CUDA `device`, tick and tock synchronize it."""

    def __init__(self, skip_first: int = 2, device=None):
        self.skip = skip_first
        self.times: list[float] = []
        self._t0 = None
        self._n = 0
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._device = device

    def _wait(self):
        if self._sync:
            torch.cuda.synchronize(self._device)

    def tick(self):
        self._wait()
        self._t0 = time.perf_counter()

    def tock(self) -> float:
        self._wait()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.skip:
            self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0
