"""Streaming memory model: DB >> RAM (VERDICT r1 item 6).

`load_db` memory-maps big `.sqn` code files (io.compress._stream_codes,
the reference's mmap model, mapFile.h:6-55) and `ConvScanner.scan`
streams halo'd blocks through the pipelined scan instead of uploading /
materializing the whole array — peak host RSS must be independent of
database size."""

import os
import subprocess
import sys

import numpy as np
import pytest

from sequence_alignment_tools.io.compress import load_db, write_idb
from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables

PAT = "ACGTTGCAACGTAGG"


def _write_sqn(base: str, n: int, planted, chunk=1 << 24, seed=9):
    """Synthetic .sqn/.tbl/.idb/.hdr artifacts written in chunks (never
    materializing the corpus), one entry, codes over ACGT + EOS."""
    rng = np.random.default_rng(seed)
    planted = sorted(planted)
    pat_codes = np.asarray([b"ACGT".index(c.encode()) for c in PAT],
                           np.uint8)
    with open(base + ".sqn", "wb") as f:
        pos = 0
        while pos < n:
            m = min(chunk, n - pos)
            block = rng.integers(0, 4, size=m, dtype=np.int64).astype(
                np.uint8)
            for p in planted:
                s, e = p - pos, p - pos + len(PAT)
                cs, ce = max(s, 0), min(e, m)
                if cs < ce:
                    block[cs:ce] = pat_codes[cs - s : ce - s]
            block.tofile(f)
            pos += m
        f.write(bytes([4]))  # trailing EOS
    with open(base + ".tbl", "wb") as f:
        f.write(b"ACGT\n")
    write_idb(base + ".idb",
              np.asarray([1, n + 2], np.int64), np.asarray([0, 3], np.int64))
    with open(base + ".hdr", "wb") as f:
        f.write(b"e1\n")


def test_streamed_scan_matches_resident(tmp_path):
    """A memmap-loaded DB scanned via the streamed block path yields the
    identical hit stream to the resident scan — including hits straddling
    every streamed-block boundary."""
    base = str(tmp_path / "small.fa")
    B = 1 << 16
    n = 6 * B
    planted = [B - 7, 2 * B - 7, 3 * B - 1, 4 * B - len(PAT), 1000]
    _write_sqn(base, n, planted)

    os.environ["SAT_STREAM_DB"] = "1"
    try:
        db = load_db(base)
    finally:
        del os.environ["SAT_STREAM_DB"]
    assert isinstance(db.codes, np.memmap)

    ps = build_pattern_set([PAT], rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)

    resident = ConvScanner(tables, k=0)
    want = sorted(resident.scan(np.asarray(db.codes)))
    assert len(want) >= len(planted)

    streamed = ConvScanner(tables, k=0)
    streamed._STREAM_BLOCK = B
    assert streamed._stream_whole(db.codes)
    got = list(streamed.scan(db.codes))
    assert sorted(got) == want
    # stream order is already the global (window-start, pattern) order
    keyed = [(e - int(tables.lengths[p]), p) for e, p, _ in got]
    assert keyed == sorted(keyed)


def test_streamed_scan_composes_with_mesh(tmp_path):
    """DB >> RAM *and* a device mesh (VERDICT r2 item 9): the streamed
    block path routes each block through the sharded pipelined scan —
    1 == N byte parity on the 8-device CPU mesh, straddles included."""
    import jax

    from sequence_alignment_tools.parallel.shard import make_mesh

    base = str(tmp_path / "mesh.fa")
    B = 1 << 16
    n = 4 * B
    planted = [B - 7, 2 * B - 7, 3 * B - 1, 500]
    _write_sqn(base, n, planted, seed=13)

    os.environ["SAT_STREAM_DB"] = "1"
    try:
        db = load_db(base)
    finally:
        del os.environ["SAT_STREAM_DB"]
    assert isinstance(db.codes, np.memmap)

    ps = build_pattern_set([PAT], rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)

    resident = ConvScanner(tables, k=0)
    want = sorted(resident.scan(np.asarray(db.codes)))
    assert len(want) >= len(planted)

    meshed = ConvScanner(tables, k=0, use_fused=True)
    meshed.force_device = True
    meshed.mesh = make_mesh(jax.devices()[:8])
    meshed._STREAM_BLOCK = B
    assert meshed._stream_whole(db.codes) and meshed._sharded_capable()
    got = list(meshed.scan(db.codes))
    assert sorted(got) == want


_RSS_SCRIPT = r"""
import os, resource, sys
import numpy as np
os.environ["SAT_STREAM_DB"] = "1"
from sequence_alignment_tools.io.compress import load_db
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables

base, pat = sys.argv[1], sys.argv[2]
db = load_db(base)
assert isinstance(db.codes, np.memmap), type(db.codes)
ps = build_pattern_set([pat], rev_comp=True)
tables = build_tables(ps, db, wc=False, textn=False)
sc = ConvScanner(tables, k=0)
hits = list(sc.scan(db.codes))
print(len(hits), resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


@pytest.mark.slow
def test_rss_independent_of_db_size(tmp_path):
    """Peak host RSS scanning a 4 GB database stays within a fixed margin
    of the RSS scanning a 256 MB one (both memmap-streamed): O(patterns +
    block) memory, not O(database)."""
    results = {}
    for name, n in (("small", 1 << 28), ("big", 1 << 32)):
        base = str(tmp_path / f"{name}.fa")
        planted = [1000, n // 2 - 7, n - len(PAT) - 5]
        _write_sqn(base, n, planted)
        r = subprocess.run(
            [sys.executable, "-c", _RSS_SCRIPT, base, PAT],
            capture_output=True, text=True, cwd="/root/repo",
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        assert r.returncode == 0, r.stderr[-2000:]
        nh, rss_kb = (int(x) for x in r.stdout.split())
        assert nh >= len(planted)
        results[name] = rss_kb
        for ext in (".sqn", ".tbl", ".idb", ".hdr"):
            os.remove(base + ext)
    # 16x the data, bounded extra RSS (block + page-cache jitter)
    assert results["big"] - results["small"] < 400_000, results  # KB
