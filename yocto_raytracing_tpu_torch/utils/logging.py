"""Structured phase logging, timers and throughput counters.

The reference has printf banners in main (src/raytrace.cpp:273-285) and an
unused leveled logger + wall-clock timer in yocto_utils.h (790-958,
1038-1073). Here the phase log is first-class: every phase gets a
wall-clock duration, and render phases report rays/s. A copy of the JAX
package's ``utils/logging.py`` with two changes: the logger is
``yrt_torch`` (the JAX package's is ``yrt``), and its handler writes to
the ``sys.stderr`` of the moment it logs, not the one it was created
under. A phase is also a span of ``tracer``.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import time

from . import tracer


class _StderrHandler(logging.StreamHandler):
    """A stream handler on whatever ``sys.stderr`` is when it emits (a
    caller or test may have replaced it since the logger was made)."""

    def emit(self, record):
        self.stream = sys.stderr
        super().emit(record)


def get_logger(name: str = "yrt_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = _StderrHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class Timer:
    """Wall-clock timer (the yu::timer equivalent, yocto_utils.h:1038-1073)."""

    def __init__(self, autostart: bool = True):
        self._start = None
        self._elapsed = 0.0
        if autostart:
            self.start()

    def start(self):
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self._elapsed

    @property
    def elapsed(self) -> float:
        if self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


@contextlib.contextmanager
def log_phase(name: str, rays: int | None = None, logger=None):
    """Context manager: log phase duration (+ Mrays/s when rays given).
    The phase is also a span ``name`` (``tracer.begin``), so it shows in a
    profiler's trace."""
    logger = logger or get_logger()
    t = Timer()
    logger.info("%s...", name)
    sp = tracer.begin(name)
    try:
        yield t
    finally:
        tracer.end(sp)
        dt = t.stop()
        if rays:
            logger.info("%s done in %.3fs (%.2f Mrays/s)", name, dt,
                        rays / max(dt, 1e-9) / 1e6)
        else:
            logger.info("%s done in %.3fs", name, dt)
