"""Phase timing utilities — the counterpart of the reference's cudaEvent
timer macros (reference: timeMeasuring.h:11-28).

The reference reports three phases per direction: transfer-to-device,
kernel, transfer-from-device (compress.h:16-18). Here the same phases
are measured with the host clock around `jax.device_put` /
dispatch + `block_until_ready` / host materialization.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimings:
    """Milliseconds per phase, reference CSV column parity
    (source.cpp:38-48)."""

    to_device_ms: float = 0.0
    kernel_ms: float = 0.0
    from_device_ms: float = 0.0

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.to_device_ms, self.kernel_ms, self.from_device_ms)


@dataclass
class PhaseTimer:
    timings: PhaseTimings = field(default_factory=PhaseTimings)
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, phase: str) -> float:
        ms = (time.perf_counter() - self._t0) * 1e3
        setattr(self.timings, f"{phase}_ms", ms)
        return ms
