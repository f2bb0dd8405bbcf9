"""Timing + profiling harness (SURVEY §5: the reference has no tracing or
profiling — only wall-clock prints in example scripts).

- ``timed``: accurate device timing via block_until_ready with warmup.
- ``trace``: context manager around jax.profiler for TensorBoard traces.
- ``log_compiles``: context manager that surfaces recompilation events —
  the practical observability tool for shape-stability bugs.
- ``gpu_card``: the GPU's name and power limit, as nvidia-smi reports them.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable

import numpy as np

import jax


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 5,
          **kwargs) -> dict:
    """Run fn(*args) with device sync; returns timing stats in seconds."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return dict(median=float(np.median(times)), best=float(np.min(times)),
                mean=float(np.mean(times)), iters=iters)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def log_compiles():
    """Log every XLA compilation inside the block (recompile detector)."""
    with jax.log_compiles():
        yield


def gpu_card() -> str:
    """``name, power.limit`` of the GPU(s), one line per card, read by
    nvidia-smi in a child process that never imports JAX (so it takes no
    share of the card).  Raises when nvidia-smi is missing or fails.
    A card set below its top power limit runs matrix-heavy work slower, so
    every timing is reported beside this line."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
