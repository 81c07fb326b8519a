"""Structured per-step metrics.

The reference's observability is print/loginfo lines (gvom.py:108,149,180;
gvom_ros.py:144-189) and a commented-out rate print (gvom_ros.py:111).
This replaces them with thread-safe counters/timers and a snapshot API.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict, deque
from typing import Dict

__all__ = ["StepMetrics"]


class StepMetrics:
    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._timings: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._t0 = time.time()

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def record(self, name: str, value: float) -> None:
        with self._lock:
            self._timings[name].append(value)

    def snapshot(self) -> Dict:
        with self._lock:
            out = {"uptime_s": round(time.time() - self._t0, 3), "counters": dict(self._counters)}
            stats = {}
            for k, v in self._timings.items():
                if v:
                    vals = list(v)
                    stats[k] = {
                        "mean": sum(vals) / len(vals),
                        "last": vals[-1],
                        "min": min(vals),
                        "max": max(vals),
                        "n": len(vals),
                    }
            out["timings"] = stats
            return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def rate(self, counter: str) -> float:
        with self._lock:
            dt = time.time() - self._t0
            return self._counters[counter] / dt if dt > 0 else 0.0
