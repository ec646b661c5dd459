"""The fused microhit scan pipeline vs the XLA block-scan reference path
(forced onto the CPU here; the same route runs on the GPU)."""

import os
import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")


@pytest.fixture(scope="module")
def planted_db():
    rng = np.random.default_rng(11)
    n = 30000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    table = b"ACGT\n"
    pats = [ln.strip() for ln in open(PAT)
            if ln.strip()]
    db = SeqDB(
        codes=codes, table=table,
        entry_starts=np.array([0]), entry_lengths=np.array([n]),
        headers=["e1"],
    )
    for i, p in enumerate(pats):
        at = 400 + 900 * i
        for j, ch in enumerate(p):
            db.codes[at + j] = table.index(ch.encode())
    # one plant straddling a rescan-bucket boundary (2048) and one near the
    # array end
    for at in (2040, n - len(pats[0]) - 1):
        for j, ch in enumerate(pats[0]):
            db.codes[at + j] = table.index(ch.encode())
    return db, pats


@pytest.mark.parametrize("k", [0, 1, 2])
def test_pallas_matches_xla_path(planted_db, k):
    db, pats = planted_db
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    ref = ConvScanner(tables, k=k, block=1 << 15, use_fused=False)
    ref.use_host = False  # pin the XLA block path
    want = list(ref.scan(db.codes))
    got_sc = ConvScanner(tables, k=k, use_fused=True)
    got_sc.force_device = True
    got = list(got_sc.scan(db.codes))
    assert got == want
    assert len(want) >= (12 if k == 0 else 12)


def test_scan_stream_matches_scan(planted_db):
    """The pipelined scan_stream yields per-block results identical to
    sequential scan() calls."""
    db, pats = planted_db
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(tables, k=0, use_fused=True)
    sc.force_device = True
    blocks = [db.codes, db.codes[: len(db.codes) // 2], db.codes]
    want = [list(sc.scan(b)) for b in blocks]
    got = dict(sc.scan_stream(iter(blocks)))
    assert [got[i] for i in range(len(blocks))] == want


def test_scan_stream_grouped_flush(planted_db):
    """Mid-stream grouped flushes through the compact group fetch
    (_pack_group), mixed block lengths in one group, and the gcap
    overflow fallback to the full stacked fetch."""
    db, pats = planted_db
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(tables, k=0, use_fused=True)
    sc.force_device = True
    blocks = [db.codes, db.codes[: len(db.codes) // 2],
              db.codes[:3000], db.codes] * 3
    want = [list(sc.scan(b)) for b in blocks]
    got = dict(sc.scan_stream(iter(blocks), depth=4))
    assert [got[i] for i in range(len(blocks))] == want
    # group overflow: gcap smaller than the live totals forces the
    # stacked-row fallback and grows gcap for subsequent groups
    sc2 = ConvScanner(tables, k=0, use_fused=True)
    sc2.force_device = True
    sc2._gcap = 8
    got2 = dict(sc2.scan_stream(iter(blocks), depth=4))
    assert [got2[i] for i in range(len(blocks))] == want
    assert sc2._gcap > 8


def test_radix_path_matches_xla(planted_db):
    """The host radix-code scan (dense exact-seed regime) yields exactly
    the XLA block path's candidate stream."""
    import numpy as np

    db, pats = planted_db
    # short seeds: the halves-engine shape that triggers the dense path
    halves = sorted({p[: len(p) // 2] for p in pats} |
                    {p[len(p) // 2 :] for p in pats})
    ps = build_pattern_set(halves, rev_comp=False)
    tables = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(tables, k=0, use_fused=False)
    sc.use_host = False  # pin the XLA block path
    want = list(sc.scan(db.codes))
    assert sc._radix_eligible()
    got = list(sc._scan_radix(db.codes))
    assert got == want
    assert len(got) > 50  # dense, non-degenerate
    # duplicate patterns fan out like the device paths
    ps2 = build_pattern_set([halves[0], halves[0], halves[1]],
                            rev_comp=False)
    t2 = build_tables(ps2, db, wc=False, textn=False)
    sc2 = ConvScanner(t2, k=0, use_fused=False)
    sc2.use_host = False
    assert list(sc2._scan_radix(db.codes)) == list(sc2.scan(db.codes))


def test_pallas_pattern_tiling(planted_db):
    """P > 128 patterns (past the old kernel's pattern tile) in one
    fused pass."""
    import numpy as np

    db, pats = planted_db
    rng = np.random.default_rng(3)
    # 150 distinct patterns (ptiles=2): the planted ones + random fillers
    fillers = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=14))
               for _ in range(150 - len(pats))]
    ps = build_pattern_set(pats + fillers, rev_comp=False)
    tables = build_tables(ps, db, wc=False, textn=False)
    assert tables.P > 128
    sc = ConvScanner(tables, k=0, use_fused=True)
    sc.force_device = True
    want_sc = ConvScanner(tables, k=0, use_fused=False)
    want_sc.use_host = False
    assert list(sc.scan(db.codes)) == list(want_sc.scan(db.codes))
