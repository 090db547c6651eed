"""File-level CLI: compress/decompress bitmap files with the WAH codec.

The reference ships a benchmark binary only (source.cpp); this adds the
obvious user-facing tool on top of the same two-function API
(compress.h:12-18, decompress.h:11-17).

File format (.wah): 16-byte header
    magic  'WAHT' | version u32 | original_ints u64 (little endian)
followed by the raw uint32 WAH word stream.

Usage:
    python -m wah_tpu compress  INPUT [-o OUTPUT.wah] [--kernel auto]
    python -m wah_tpu decompress INPUT.wah [-o OUTPUT] [--kernel auto]
    python -m wah_tpu info INPUT.wah
    python -m wah_tpu logical OP A.wah B.wah [C.wah ...] -o OUT.wah
Input bitmaps are raw little-endian uint32 words (any byte length; a
trailing partial word is zero-padded and restored on decompress).
`logical` combines compressed files in the compressed domain
(op: and/or/xor/andnot; andnot is pairwise-left-folded, the rest use
the fused k-way reduce); operands must decompress to equal lengths.
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

MAGIC = b"WAHT"
VERSION = 1
_HDR = struct.Struct("<4sIQ")


def _read_bitmap(path: str) -> tuple[np.ndarray, int]:
    raw = open(path, "rb").read()
    nbytes = len(raw)
    pad = (-nbytes) % 4
    if pad:
        raw += b"\0" * pad
    return np.frombuffer(raw, dtype="<u4").astype(np.uint32), nbytes


def _write_wah(path: str, stream: np.ndarray, original_bytes: int) -> None:
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, original_bytes))
        f.write(stream.astype("<u4").tobytes())


def _read_wah(path: str) -> tuple[np.ndarray, int]:
    raw = open(path, "rb").read()
    magic, version, original_bytes = _HDR.unpack(raw[: _HDR.size])
    if magic != MAGIC:
        sys.exit(f"{path}: not a WAH file (bad magic)")
    if version != VERSION:
        sys.exit(f"{path}: unsupported version {version}")
    stream = np.frombuffer(raw[_HDR.size :], dtype="<u4").astype(np.uint32)
    return stream, original_bytes


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="wah_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("compress", "decompress", "info"):
        sp = sub.add_parser(name)
        sp.add_argument("input")
        if name != "info":
            sp.add_argument("-o", "--output")
            sp.add_argument("--kernel", default="auto",
                            choices=["auto", "xla", "native"])
    sp = sub.add_parser("logical")
    sp.add_argument("op", choices=["and", "or", "xor", "andnot"])
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--kernel", default="auto",
                    choices=["auto", "xla"])
    args = p.parse_args(argv)

    if args.cmd == "logical":
        from .api import WahCodec

        pairs = [_read_wah(f) for f in args.inputs]
        lengths = {ob for _, ob in pairs}
        if len(lengths) != 1:
            sys.exit(f"operands decompress to different lengths: {lengths}")
        original_bytes = pairs[0][1]
        n_ints = (original_bytes + 3) // 4
        codec = WahCodec(kernel=args.kernel)
        streams = [s for s, _ in pairs]
        if args.op == "andnot" or len(streams) == 2:
            acc = streams[0]
            for s in streams[1:]:
                acc = codec.logical(acc, s, args.op, n_ints)
        else:
            acc = codec.logical_many(streams, args.op, n_ints)
        _write_wah(args.output, acc, original_bytes)
        print(f"{args.op}({', '.join(args.inputs)}) -> {args.output} "
              f"({acc.nbytes} B stream)")
        return

    if args.cmd == "info":
        stream, original_bytes = _read_wah(args.input)
        from .api import validate_stream
        from .native import available, decoded_chunks

        validate_stream(stream)
        if available():
            chunks = decoded_chunks(stream)
        else:
            from .constants import BIT31, LEN_MASK

            is_fill = (stream & np.uint32(BIT31)) != 0
            chunks = int(
                np.where(is_fill, stream & np.uint32(LEN_MASK), 1).sum()
            )
        print(f"{args.input}: {stream.size} words, {chunks} chunks, "
              f"original {original_bytes} bytes, "
              f"ratio {stream.nbytes / max(original_bytes, 1):.4f}")
        return

    if args.cmd == "compress":
        data, nbytes = _read_bitmap(args.input)
        if args.kernel == "native":
            from . import native

            stream = native.encode(data)
        else:
            from .api import WahCodec

            stream, _ = WahCodec(kernel=args.kernel).compress(data)
        out = args.output or (args.input + ".wah")
        _write_wah(out, stream, nbytes)
        print(f"{args.input} ({nbytes} B) -> {out} "
              f"({_HDR.size + stream.nbytes} B, "
              f"ratio {stream.nbytes / max(nbytes, 1):.4f})")
        return

    stream, original_bytes = _read_wah(args.input)
    n_ints = (original_bytes + 3) // 4
    if args.kernel == "native":
        from . import native

        data = native.decode(stream, out_ints=n_ints)
    else:
        from .api import WahCodec

        data, _ = WahCodec(kernel=args.kernel).decompress(
            stream, out_ints=n_ints
        )
    out = args.output or (
        args.input[:-4] if args.input.endswith(".wah")
        else args.input + ".out"
    )
    with open(out, "wb") as f:
        f.write(data.astype("<u4").tobytes()[:original_bytes])
    print(f"{args.input} -> {out} ({original_bytes} B)")


if __name__ == "__main__":
    from .backend import enable_compile_cache

    enable_compile_cache()
    main()
