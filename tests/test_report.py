"""Benchmark report CLI smoke test: CSV schema parity + resumability."""
import csv
import os

from benchmarks import report


def test_report_sweep_and_resume(tmp_path):
    out = tmp_path / "results.txt"
    args = [
        "--sizes", "1", "--densities", "1", "8",
        "--reps", "1", "--out", str(out),
    ]
    report.main(args)
    rows = list(csv.reader(open(out)))
    assert rows[0] == report.HEADER
    assert len(rows) == 3  # header + 2 configs
    for row in rows[1:]:
        assert len(row) == len(report.HEADER)
        n, comp, dec = int(row[0]), int(row[1]), int(row[2])
        assert n == 1024 * 992 and dec == n and 0 < comp
        assert 0.0 < float(row[4]) <= 1.1  # compression ratio

    # resume: completed configs skipped, no duplicate rows
    mtime = os.path.getmtime(out)
    report.main(args)
    rows2 = list(csv.reader(open(out)))
    assert len(rows2) == 3


def test_report_density_affects_ratio(tmp_path):
    out = tmp_path / "r.txt"
    report.main(
        ["--sizes", "1", "--densities", "2", "12", "--reps", "1",
         "--out", str(out)]
    )
    rows = list(csv.reader(open(out)))[1:]
    by_density = {float(r[3]): float(r[4]) for r in rows}
    dense, sparse = by_density[2.0 ** -2], by_density[2.0 ** -12]
    assert sparse < dense  # sparser bitmaps compress better


def test_generate_random_data_slab_invariance():
    """Slab-chunked generation must equal the monolithic draw (the old
    code path) so committed sweep results stay comparable."""
    import numpy as np

    from benchmarks.report import generate_random_data

    n = (1 << 21) + 12345  # crosses one slab boundary
    rng = np.random.default_rng(1337)
    bits = rng.integers(0, 16, size=(n, 32), dtype=np.int64) == 0
    want = (
        np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
        .view(np.uint32)
        .reshape(-1)
    )
    np.testing.assert_array_equal(generate_random_data(n, 16), want)


def test_summarize_markdown(tmp_path):
    """summarize renders one md row per size plus the all-row, with
    GB/s aggregated from the throughput columns."""
    from benchmarks import summarize

    out = tmp_path / "r.txt"
    report.main(
        ["--sizes", "1", "--densities", "2", "12", "--reps", "1",
         "--out", str(out)]
    )
    rows = summarize.load_rows(str(out))
    assert len(rows) == 2
    md = summarize.summarize(rows)
    lines = md.splitlines()
    assert lines[0].startswith("| bitmap ")
    assert len(lines) == 4  # header, sep, one size row, all-row
    assert "4.1 MB" in lines[2] and "| 2 |" in lines[2]


def test_summarize_inject(tmp_path):
    from benchmarks import summarize

    md = tmp_path / "x.md"
    md.write_text(
        "head\n<!-- sweep-summary:begin -->\nstale\n"
        "<!-- sweep-summary:end -->\ntail\n"
    )
    summarize.inject(str(md), "| new |")
    text = md.read_text()
    assert "stale" not in text and "| new |" in text
    assert text.startswith("head\n") and text.endswith("tail\n")

