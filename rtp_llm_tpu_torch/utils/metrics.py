"""In-process metrics registry.

Port of ``rtp_llm_tpu/utils/metrics.py``.

Analog of the reference's kmonitor metric reporters (rtp_llm/metrics/
kmonitor_metric_reporter.py:105, cpp/metrics/RtpLLMMetrics.h) without the agent
dependency: counters / gauges / histograms kept in-process and exposed via the
frontend ``/worker_status`` + ``/metrics`` routes.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, List


class _Histogram:
    __slots__ = ("values", "count", "total")

    def __init__(self):
        self.values: List[float] = []
        self.count = 0
        self.total = 0.0

    def observe(self, v: float):
        self.count += 1
        self.total += v
        self.values.append(v)
        if len(self.values) > 10000:  # bounded memory
            self.values = self.values[-5000:]

    def percentile(self, p: float) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        idx = min(int(len(s) * p / 100.0), len(s) - 1)
        return s[idx]

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "avg": self.total / self.count if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = defaultdict(_Histogram)
        self.start_time = time.time()

    def inc(self, name: str, v: float = 1.0):
        with self._lock:
            self._counters[name] += v

    def set_gauge(self, name: str, v: float):
        with self._lock:
            self._gauges[name] = v

    def observe(self, name: str, v: float):
        with self._lock:
            self._hists[name].observe(v)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_s": time.time() - self.start_time,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot() for k, h in self._hists.items()},
            }

    def prometheus_text(self, prefix: str = "rtp") -> str:
        """Render the registry in Prometheus text exposition format
        (reference analog: the kmonitor reporter sinks RtpLLMSchedulerMetrics
        / RtpLLMExecutorMetrics to an agent; here any Prometheus scraper can
        pull the same per-phase timings, queue depths and cache gauges from
        GET /metrics)."""

        def name_of(k: str) -> str:
            return prefix + "_" + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in k)

        lines: List[str] = []
        with self._lock:
            lines.append(f"# TYPE {prefix}_uptime_seconds gauge")
            lines.append(
                f"{prefix}_uptime_seconds {time.time() - self.start_time:.3f}")
            for k in sorted(self._counters):
                n = name_of(k) + "_total"
                lines.append(f"# TYPE {n} counter")
                lines.append(f"{n} {self._counters[k]:g}")
            for k in sorted(self._gauges):
                n = name_of(k)
                lines.append(f"# TYPE {n} gauge")
                lines.append(f"{n} {self._gauges[k]:g}")
            for k in sorted(self._hists):
                h = self._hists[k]
                n = name_of(k)
                lines.append(f"# TYPE {n} summary")
                for q, p in ((0.5, 50), (0.9, 90), (0.99, 99)):
                    lines.append(
                        f'{n}{{quantile="{q}"}} {h.percentile(p):g}')
                lines.append(f"{n}_sum {h.total:g}")
                lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"


METRICS = MetricsRegistry()


class timed:
    """Context manager observing elapsed ms into a histogram."""

    def __init__(self, name: str, registry: MetricsRegistry = METRICS):
        self.name = name
        self.registry = registry

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.registry.observe(self.name, (time.perf_counter() - self.t0) * 1e3)
        return False
