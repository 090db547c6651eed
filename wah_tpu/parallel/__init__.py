"""Multi-device parallelism: mesh construction + sharded encode/decode."""
from .dist import (
    AXIS,
    ShardedCodec,
    decode_sharded,
    encode_sharded,
    estimate_word_cap,
    gather_bitmap,
    gather_stream,
    make_mesh,
    stitch_global,
    stitch_word_cap,
)

__all__ = [
    "AXIS",
    "ShardedCodec",
    "decode_sharded",
    "encode_sharded",
    "estimate_word_cap",
    "gather_bitmap",
    "gather_stream",
    "make_mesh",
    "stitch_global",
    "stitch_word_cap",
]
