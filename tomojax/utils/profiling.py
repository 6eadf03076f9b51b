"""Profiling and timing instrumentation.

Replaces the reference's debug wall-clock prints (``sirt.py:80-82``,
``sirt_mpi.py:142-144``) with jax.profiler traces and synchronized timers
(xprof-compatible; view with TensorBoard or Perfetto)."""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: ``with trace('/tmp/trace'): step()``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, reps: int = 1, warmup: int = 1, **kwargs):
    """Synchronized timing: returns (last_result, seconds_per_call).

    block_until_ready after every call so device work is counted (the
    reference times unsynchronized Python wall-clock)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / max(reps, 1)


class IterationTimer:
    """Accumulates per-iteration wall times for host-side loops."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def total(self):
        return sum(self.times)

    @property
    def mean(self):
        return self.total / max(len(self.times), 1)


def device_summary(log_dir: str, top: int = 12) -> dict:
    """Reduce the newest ``jax.profiler`` trace under ``log_dir`` to device
    times: for every line of every ``/device:`` plane, the event count,
    the summed duration, the busy time (union of the event intervals),
    the window from first start to last end, and the ``top`` event names
    by summed duration. Times in milliseconds."""
    import glob
    import os
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {}
        for line in plane.lines:
            evs = sorted((e.start_ns, e.duration_ns, e.name)
                         for e in line.events)
            if not evs:
                continue
            by_name: dict = {}
            busy, cur_s, cur_e = 0.0, None, None
            for s, d, name in evs:
                by_name[name] = by_name.get(name, 0.0) + d
                if cur_e is None or s > cur_e:
                    if cur_e is not None:
                        busy += cur_e - cur_s
                    cur_s, cur_e = s, s + d
                else:
                    cur_e = max(cur_e, s + d)
            busy += cur_e - cur_s
            window = max(s + d for s, d, _ in evs) - evs[0][0]
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
            lines[line.name] = {
                "n": len(evs),
                "sum_ms": sum(d for _, d, _ in evs) / 1e6,
                "busy_ms": busy / 1e6, "window_ms": window / 1e6,
                "top_ms": [(n, d / 1e6) for n, d in ranked]}
        out[plane.name] = lines
    return out
