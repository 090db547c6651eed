"""wah_tpu — WAH (Word-Aligned Hybrid) bitmap compression in JAX.

A JAX re-design of the GPU-WAH codec (Andrzejewski & Wrembel, DEXA
2010): 31-bit-chunk word-aligned hybrid run-length encoding with
complete fill coalescing inside 1024-chunk blocks, bit-compatible with
the reference GPU implementation.

Public API:
  compress(bitmap)   -> (stream, timings)     host convenience
  decompress(stream) -> (bitmap, timings)
  WahCodec           class with execution-path selection + jit caching
  backend            platform -> execution path; compile cache
  ops.encode / ops.decode      jittable XLA pipelines
  parallel.*                   sharded encode/decode over a mesh
  golden             NumPy oracle
"""
from . import constants, golden
from .api import WahCodec, compress, decompress, validate_stream
from .interop import rechunk_stream

__version__ = "0.1.0"

__all__ = [
    "constants",
    "golden",
    "WahCodec",
    "compress",
    "decompress",
    "validate_stream",
    "rechunk_stream",
    "__version__",
]
