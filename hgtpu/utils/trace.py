"""Per-stage wall-time tracing.

The reference has no profiling at all (SURVEY.md §5: "Tracing/profiling:
none — only timestamped progress prints", hisatgenotype:116).  A
device pipeline needs one badly: the typing path interleaves host
numpy/C++ stages with asynchronous device dispatches, so the only way to
know where reads/s go is to time each stage.

Usage:

    from hgtpu.utils.trace import TRACE
    with TRACE.stage("place.dispatch"):
        ...
    TRACE.summary()   # {stage: {"s": total, "n": calls}}
    TRACE.report(sys.stderr)

Collection cost is two perf_counter calls + a dict update per block —
stages are chunk-granular, never per-read, so it stays on by default.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class StageTimer:
    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._s = {}
            self._n = {}

    @contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.add(name, dt)

    def add(self, name, dt, n=1):
        with self._lock:
            self._s[name] = self._s.get(name, 0.0) + dt
            self._n[name] = self._n.get(name, 0) + n

    def summary(self):
        with self._lock:
            return {k: {"s": self._s[k], "n": self._n[k]}
                    for k in sorted(self._s)}

    def total(self, prefix=""):
        """Sum of stage seconds under a dotted prefix ("" = all)."""
        with self._lock:
            return sum(v for k, v in self._s.items()
                       if not prefix or k == prefix
                       or k.startswith(prefix + "."))

    def report(self, file=None, min_s=0.0):
        import sys
        file = file or sys.stderr
        summ = self.summary()
        if not summ:
            return
        width = max(len(k) for k in summ)
        grand = sum(v["s"] for v in summ.values())
        print("[trace] %-*s %10s %8s %6s" % (width, "stage", "seconds",
                                             "calls", "share"), file=file)
        for k, v in sorted(summ.items(), key=lambda kv: -kv[1]["s"]):
            if v["s"] < min_s:
                continue
            print("[trace] %-*s %10.3f %8d %5.1f%%"
                  % (width, k, v["s"], v["n"],
                     100.0 * v["s"] / grand if grand else 0.0), file=file)


TRACE = StageTimer()
