"""Summarize a sweep CSV (benchmarks.report schema) as a Markdown table.

The reference emits raw CSV only (source.cpp:38-48); its README has no
numbers. This renders a sweep's rows as a table (or rewrites a Markdown
file's marker block with it, `--inject`):

  python -m benchmarks.summarize results.txt

Prints one Markdown table: a row per bitmap size, kernel-phase GB/s
(device-timed, transfers excluded — column semantics per
benchmarks.report) aggregated as median (min-max) across the density
sweep, plus the compression-ratio span.
"""
from __future__ import annotations

import argparse
import csv
import sys
from collections import defaultdict


def load_rows(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].lstrip().startswith(("#", "Original")):
                continue
            rows.append(
                {
                    "n_ints": int(row[0]),
                    "comp_ints": int(row[1]),
                    "density": float(row[3]),
                    "ratio": float(row[4]),
                    "enc_gbps": float(row[11]),
                    "dec_gbps": float(row[12]),
                }
            )
    return rows


def _med(xs: list[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def summarize(rows: list[dict]) -> str:
    by_size: dict[int, list[dict]] = defaultdict(list)
    for r in rows:
        by_size[r["n_ints"]].append(r)
    out = [
        "| bitmap | configs | encode GB/s med (min-max) | "
        "decode GB/s med (min-max) | ratio span |",
        "|---|---|---|---|---|",
    ]
    for n in sorted(by_size):
        rs = by_size[n]
        enc = [r["enc_gbps"] for r in rs]
        dec = [r["dec_gbps"] for r in rs]
        ratio = [r["ratio"] for r in rs]
        mb = n * 4 / 1e6
        size = f"{mb:.1f} MB" if mb < 1000 else f"{mb / 1000:.2f} GB"
        out.append(
            f"| {size} | {len(rs)} "
            f"| {_med(enc):.1f} ({min(enc):.1f}-{max(enc):.1f}) "
            f"| {_med(dec):.1f} ({min(dec):.1f}-{max(dec):.1f}) "
            f"| {min(ratio):.4f}-{max(ratio):.4f} |"
        )
    enc = [r["enc_gbps"] for r in rows]
    dec = [r["dec_gbps"] for r in rows]
    out.append(
        f"| **all** | {len(rows)} | {_med(enc):.1f} "
        f"({min(enc):.1f}-{max(enc):.1f}) | {_med(dec):.1f} "
        f"({min(dec):.1f}-{max(dec):.1f}) | — |"
    )
    return "\n".join(out)


MARK_BEGIN = "<!-- sweep-summary:begin -->"
MARK_END = "<!-- sweep-summary:end -->"


def inject(md_path: str, table: str) -> None:
    """Replace the sweep-summary marker block in a Markdown file."""
    text = open(md_path).read()
    lo = text.index(MARK_BEGIN) + len(MARK_BEGIN)
    hi = text.index(MARK_END)
    open(md_path, "w").write(text[:lo] + "\n" + table + "\n" + text[hi:])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results", help="sweep CSV (benchmarks.report schema)")
    p.add_argument("--inject", metavar="MD",
                   help="rewrite MD's sweep-summary marker block in "
                        "place instead of printing")
    args = p.parse_args(argv)
    rows = load_rows(args.results)
    if not rows:
        print("no data rows found", file=sys.stderr)
        sys.exit(1)
    table = summarize(rows)
    if args.inject:
        inject(args.inject, table)
    else:
        print(table)


if __name__ == "__main__":
    main()
