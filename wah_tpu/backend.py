"""Execution-path switch and compile cache.

`execution_path` is the one place that maps JAX's platform to the path
the codec runs. Every platform, the CPU and the GPU alike, runs the
plain XLA ops (`ops/encode.py`, `ops/decode.py`): on the H100 a
hand-written encode kernel won device time but no end-to-end time over
what XLA makes of them, and was not kept (PERF.md, Kernel decisions).
"""
from __future__ import annotations

import os

import jax

__all__ = ["XLA", "PATHS", "execution_path", "resolve", "enable_compile_cache"]

XLA = "xla"
PATHS = (XLA,)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def execution_path(platform: str | None = None) -> str:
    """Platform name ("cpu", "gpu", ...) -> execution path."""
    return XLA


def resolve(path: str | None) -> str:
    """A caller's path choice, with None or "auto" meaning the platform's."""
    if path in (None, "auto"):
        return execution_path()
    if path not in PATHS:
        raise ValueError(f"unknown execution path {path!r}; one of {PATHS}")
    return path


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses that
    directory and nothing is changed. Otherwise the cache is the fixed
    directory `.jax_cache` at the root of the checkout (git-ignored), so
    that every process of the checkout finds what an earlier one
    compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
