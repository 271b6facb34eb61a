"""Wall-clock timing with event laps (reference /root/reference/timingRoutines.py:12)
and structured device tracing.

On an async backend like a GPU, timing a jax computation requires blocking on the
result; ``Timer.evt``/``end`` accept an optional array (or pytree) to
``block_until_ready`` before taking the timestamp.

The reference's profiling story is manual (Timer laps + CUDA events + nvprof
comments, SURVEY §5); here the structured equivalent is ``trace`` /
``annotate``, thin wrappers over jax.profiler that emit xprof-compatible
traces viewable in TensorBoard/xprof.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device+host profiler trace into ``logdir`` (xprof format).

    Usage::

        with trace("/tmp/tr"):
            out = fast_xcorr(...)
            jax.block_until_ready(out)
    """
    with jax.profiler.trace(logdir):
        yield


def annotate(name: str):
    """Named span that shows up on the host timeline inside a ``trace``
    capture (``with annotate("xcorr-chunk"): ...``)."""
    return jax.profiler.TraceAnnotation(name)


class Timer:
    def __init__(self):
        self._t0 = None
        self._laps: list[tuple[str, float]] = []

    def start(self):
        self._t0 = time.perf_counter()
        self._laps = []
        return self

    def evt(self, label: str = "", block_on=None) -> float:
        """Record a lap. Returns seconds since the previous lap (or start)."""
        if block_on is not None:
            jax.block_until_ready(block_on)
        now = time.perf_counter()
        prev = self._laps[-1][1] if self._laps else self._t0
        self._laps.append((label, now))
        return now - prev

    def end(self, block_on=None) -> float:
        """Total seconds since start()."""
        if block_on is not None:
            jax.block_until_ready(block_on)
        return time.perf_counter() - self._t0

    def rpt(self):
        prev = self._t0
        for label, t in self._laps:
            print(f"{label}: {t - prev:.6f}s")
            prev = t
        if self._laps:
            print(f"Total: {self._laps[-1][1] - self._t0:.6f}s")
