"""Fault tolerance, ported from `repro/train/fault_tolerance.py`.

`PreemptionHandler` turns SIGTERM/SIGINT into a cooperative "checkpoint now
and exit 43" request; the launcher treats exit code 43 as "restart me with
--resume auto".  `StragglerMonitor` keeps an EWMA of each host's step time
and flags hosts persistently slower than `ratio` x the median.
`StepTimer` times one step.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Dict, List, Optional

RESTART_EXIT_CODE = 43


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = threading.Event()
        self._orig = {}
        for s in signals:
            try:
                self._orig[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def simulate(self):  # for tests and chaos drills
        self._flag.set()

    def restore(self):
        for s, h in self._orig.items():
            signal.signal(s, h)


class StragglerMonitor:
    """Per-host EWMA step times; flag hosts slower than ratio x median."""

    def __init__(self, n_hosts: int, alpha: float = 0.1, ratio: float = 1.5,
                 patience: int = 3):
        self.ewma: Dict[int, float] = {}
        self.strikes: Dict[int, int] = {h: 0 for h in range(n_hosts)}
        self.alpha = alpha
        self.ratio = ratio
        self.patience = patience

    def record(self, host: int, dt: float):
        prev = self.ewma.get(host)
        self.ewma[host] = dt if prev is None else (
            (1 - self.alpha) * prev + self.alpha * dt)

    def record_all(self, dts: Dict[int, float]) -> List[int]:
        for h, dt in dts.items():
            self.record(h, dt)
        return self.flagged()

    def flagged(self) -> List[int]:
        if len(self.ewma) < 2:
            return []
        vals = sorted(self.ewma.values())
        median = vals[len(vals) // 2]
        out = []
        for h, v in self.ewma.items():
            if v > self.ratio * median:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0
            if self.strikes.get(h, 0) >= self.patience:
                out.append(h)
        return out


class StepTimer:
    """`with StepTimer() as tm: ...` leaves the seconds in `tm.dt`; the
    body must wait for the device itself."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.dt: Optional[float] = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.dt = time.perf_counter() - self.t0
        return False
