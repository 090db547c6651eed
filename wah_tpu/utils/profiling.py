"""Profiling helpers: device timeline traces and their reduction.

The reference measures kernels with cudaEvents (timeMeasuring.h:11-28).
Here `trace(...)` captures a jax.profiler timeline, and `device_time`
reduces the newest trace in a directory to per-device busy time and
per-kernel device time.
"""
from __future__ import annotations

import glob
import os
from collections import Counter
from contextlib import contextmanager

import jax

__all__ = ["trace", "device_time"]


@contextmanager
def trace(logdir: str):
    """Capture a device profile around a block: tensorboard --logdir=..."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def _union_ns(intervals) -> int:
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


_HOST_COPIES = ("MemcpyH2D", "MemcpyD2H")


def _is_host_copy(name: str) -> bool:
    return any(c in name for c in _HOST_COPIES)


def device_time(logdir: str, prefix: str = "/device:GPU") -> dict:
    """Reduce the newest trace under `logdir`.

    For each device plane whose name starts with `prefix`: `busy_s`, the
    union of the intervals in which any kernel ran (events of the
    plane's "Stream" lines, or of all its lines where it has none;
    copies between host and device, and the lines that hold only them,
    are left out); `span_s`, first kernel start to last kernel end;
    `kernels`, the summed device seconds of each kernel name; and
    `lines`, the names of the lines counted."""
    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(logdir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith(prefix):
            continue
        lines = [ln for ln in plane.lines if not _is_host_copy(ln.name)]
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        lines = streams or lines
        events = [e for ln in lines for e in ln.events
                  if not _is_host_copy(e.name)]
        if not events:
            continue
        kernels = Counter()
        for e in events:
            kernels[e.name] += e.duration_ns
        out[plane.name] = {
            "busy_s": _union_ns((e.start_ns, e.end_ns) for e in events) / 1e9,
            "span_s": (max(e.end_ns for e in events)
                       - min(e.start_ns for e in events)) / 1e9,
            "kernels": {k: v / 1e9 for k, v in kernels.most_common()},
            "lines": [ln.name for ln in lines],
        }
    return out
