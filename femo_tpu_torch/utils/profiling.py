"""Profiling and timing utilities (port of femo_tpu/utils/profiling.py).

A cProfile decorator dumping per-process stats, stage timers around
solves, accumulating named stage timers, and a device trace.  `Timer`
synchronizes the card around its interval (sync=True) when a card is in
use; on CPU tensors there is nothing to wait for.  `device_trace` records
a `torch.profiler` trace (CPU and, with a card, CUDA activity), written
as a Chrome trace under `logdir`.
"""

from __future__ import annotations

import contextlib
import cProfile
import functools
import os
import time

import torch


def profile(filename: str | None = None, comm=None):
    """cProfile decorator; dumps stats to `<filename>.<pid>` (the
    reference's MPI rank becomes the process id)."""

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            pr = cProfile.Profile()
            pr.enable()
            try:
                return f(*args, **kwargs)
            finally:
                pr.disable()
                if filename:
                    pr.dump_stats(f"{filename}.{os.getpid()}")

        return wrapper

    return decorator


class Timer:
    """Stage timer with device synchronization.

    >>> with Timer("solve nonlinear") as t: ...
    prints "solve nonlinear finished in ... seconds"."""

    def __init__(self, name: str = "", sync: bool = True, report: bool = True):
        self.name = name
        self.sync = sync
        self.report = report
        self.elapsed = 0.0

    def _sync(self):
        # CUDA is initialized only by code that has used the card
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self._t0
        if self.report:
            print(f"{self.name} finished in {self.elapsed:.6f} seconds")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the block to
    `<logdir>/trace.<pid>.json` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tprofile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace.{os.getpid()}.json"))


class StageTimers:
    """Accumulating named stage timers (per-stage totals of the
    dynamic-FSI run scripts)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        for k in sorted(self.totals):
            print(f"  {k}: {self.totals[k]:.3f}s over {self.counts[k]} calls")
