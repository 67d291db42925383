"""Profiling and timing helpers.

Port of convex_dim_red_tpu/utils/profiling.py.  The reference times
every outer iteration with ``time.perf_counter`` and the estimators
keep ``avg_time_per_iter`` and ``cost_deltas``; these helpers add a
device trace (``torch.profiler`` in the JAX package's
``jax.profiler`` place) and wall-clock timing that waits for the card.
"""

import contextlib
import os
import time

import torch

__all__ = ["trace", "Timer", "block_and_time"]


@contextlib.contextmanager
def trace(log_dir):
    """Trace the enclosed work with ``torch.profiler`` (CPU activity,
    and CUDA activity where a card is present) and write the trace into
    ``log_dir`` as a ``*.pt.trace.json`` file (view it in TensorBoard's
    profiler plugin or Perfetto).  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


class Timer:
    """Accumulating wall-clock timer with per-lap records."""

    def __init__(self):
        self.laps = []
        self._start = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.laps.append(time.perf_counter() - self._start)

    @property
    def total(self):
        return sum(self.laps)

    @property
    def mean(self):
        return self.total / len(self.laps) if self.laps else 0.0


def _on_card(result):
    """Whether ``result`` (a tensor, or a tuple, list or dict of them)
    holds a tensor on a CUDA device."""
    if isinstance(result, torch.Tensor):
        return result.is_cuda
    if isinstance(result, dict):
        return any(_on_card(v) for v in result.values())
    if isinstance(result, (tuple, list)):
        return any(_on_card(v) for v in result)
    return False


def _block(result):
    if _on_card(result):
        torch.cuda.synchronize()
    return result


def block_and_time(fn, *args, repeats=1, **kwargs):
    """Run ``fn`` ``repeats`` times, waiting for the card when its result
    lies there (``torch.cuda.synchronize()``); returns ``(result,
    seconds_per_call)``, the first (warm-up) call excluded."""
    result = _block(fn(*args, **kwargs))
    start = time.perf_counter()
    for _ in range(repeats):
        result = _block(fn(*args, **kwargs))
    return result, (time.perf_counter() - start) / max(repeats, 1)
