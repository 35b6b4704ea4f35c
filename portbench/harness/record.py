"""What a per-layer metric's reader is given: the run's configuration and
traffic; the unprofiled window's counts of work, length and spans (the
host-clock metrics' source); and the profiled window's reduced trace with
its own counts of work (the device-trace metrics' source)."""
from __future__ import annotations


class RunRecord:
    def __init__(self, cell, out: dict):
        self.config = cell.config
        self.traffic = cell.traffic
        self.work = out["work"]
        self.spans = out["spans"]
        self.trace = out["trace"]
        self.window_s = out["window_s"]

    @property
    def traced_work(self) -> dict:
        """The profiled window's counts of work (empty without a trace)."""
        return self.trace["window_work"] if self.trace else {}

    def mean_ms(self, span: str):
        s = self.spans.get(span)
        return 1e3 * sum(s) / len(s) if s else None

    def kernel_seconds(self, part: str) -> float:
        """Device seconds of the kernels whose name contains ``part``."""
        if not self.trace:
            return 0.0
        return sum(v[0] for name, v in self.trace["kernels"].items() if part in name)

    def kernel_launches(self, part: str) -> int:
        """Launches in the trace of the kernels whose name contains ``part``."""
        if not self.trace:
            return 0
        return sum(v[1] for name, v in self.trace["kernels"].items() if part in name)

    def idle_share(self):
        if not self.trace or self.trace["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])
