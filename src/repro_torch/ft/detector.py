"""Heartbeat-based failure detection (the paper's 50s Flink taskmanager
timeout maps to ``timeout_s``)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class HeartbeatDetector:
    num_hosts: int
    timeout_s: float = 50.0
    _last: dict = field(default_factory=dict)

    def heartbeat(self, host: int, t: float) -> None:
        self._last[host] = t

    def heartbeat_all(self, t: float) -> None:
        for h in range(self.num_hosts):
            self._last[h] = t

    def failed_hosts(self, t: float) -> list[int]:
        return [h for h in range(self.num_hosts)
                if t - self._last.get(h, -1e18) > self.timeout_s]

    def healthy(self, t: float) -> bool:
        return not self.failed_hosts(t)

    def detection_delay(self) -> float:
        """Expected detection latency for a crash (uniform in [0, timeout])
        plus the timeout itself — used by the simulator's recovery model."""
        return self.timeout_s
