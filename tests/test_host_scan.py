"""Native shift-and host scanner vs the XLA conv path.

The host machine (native/shift_and.cpp via ops/host_scan.py) must produce
the IDENTICAL candidate stream — same (end, pattern, mism) tuples in the
same (window_start, pattern) order — as the device paths, across wildcard
classes, k-mismatch rows, EOS poison barriers and multiword state.
"""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.host_scan import HostShiftAnd
from sequence_alignment_tools.ops.tables import build_tables


def _db(rng, n, sigma=4, entries=1):
    codes = rng.integers(0, sigma, size=n).astype(np.uint8)
    table = b"ACGT"[:sigma] + b"\n"
    eos = sigma
    starts, lens = [], []
    if entries > 1:
        cuts = sorted(rng.choice(np.arange(1, n - 1), entries - 1,
                                 replace=False))
        prev = 0
        for c in list(cuts) + [n]:
            starts.append(prev)
            lens.append(c - prev)
            prev = c
        for c in cuts:
            codes[c] = eos
    else:
        starts, lens = [0], [n]
    return SeqDB(codes=codes, table=table,
                 entry_starts=np.array(starts),
                 entry_lengths=np.array(lens),
                 headers=[f"e{i}" for i in range(len(starts))])


def _plant(db, pats, rng, copies=3):
    table = db.table
    for p in pats:
        for _ in range(copies):
            at = int(rng.integers(0, len(db.codes) - len(p)))
            for j, ch in enumerate(p):
                code = table.index(ch.upper().encode()) \
                    if ch.upper().encode() in table else 0
                db.codes[at + j] = code


def _host(tables, k, poison=None):
    sc = ConvScanner(tables, k=k, poison_eos=poison, use_fused=False)
    sc.use_host = True
    assert sc._host_eligible(1 << 20)
    return sc


def _xla(tables, k, poison=None):
    sc = ConvScanner(tables, k=k, poison_eos=poison, block=1 << 14,
                     use_fused=False)
    sc.use_host = False
    return sc


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_fuzz_parity(k):
    rng = np.random.default_rng(100 + k)
    for trial in range(4):
        n = int(rng.integers(2000, 40000))
        db = _db(rng, n, entries=int(rng.integers(1, 5)))
        npat = int(rng.integers(1, 12))
        pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=int(
            rng.integers(max(4, k + 2), 18)))) for _ in range(npat)]
        _plant(db, pats, rng)
        ps = build_pattern_set(pats, rev_comp=bool(rng.integers(0, 2)))
        tables = build_tables(ps, db, wc=False, textn=False)
        want = list(_xla(tables, k).scan(db.codes))
        got = list(_host(tables, k).scan(db.codes))
        assert got == want, (k, trial, len(got), len(want))


def test_wildcard_classes():
    """IUPAC classes ride the accept table: N/R/Y patterns match their
    compatibility sets, with and without the text-N rule."""
    rng = np.random.default_rng(7)
    db = _db(rng, 20000, entries=2)
    pats = ["ACGTNRY", "NNACGT", "AYGTRA"]
    _plant(db, [p.replace("N", "A").replace("R", "A").replace("Y", "C")
                for p in pats], rng)
    for textn in (False, True):
        ps = build_pattern_set(pats, rev_comp=False)
        tables = build_tables(ps, db, wc=True, textn=textn)
        for k in (0, 1):
            want = list(_xla(tables, k).scan(db.codes))
            got = list(_host(tables, k).scan(db.codes))
            assert got == want
            assert want, (textn, k)


def test_eos_poison_barrier():
    """k>0 with poison: no candidate window straddles an entry boundary;
    without poison, EOS counts as a plain mismatch — both must agree with
    the conv weights' semantics."""
    rng = np.random.default_rng(9)
    db = _db(rng, 8000, entries=40)
    pats = ["ACGTACGT"]
    _plant(db, pats, rng, copies=8)
    ps = build_pattern_set(pats, rev_comp=False)
    tables = build_tables(ps, db, wc=False, textn=False)
    for poison in (True, False):
        for k in (1, 2):
            want = list(_xla(tables, k, poison).scan(db.codes))
            got = list(_host(tables, k, poison).scan(db.codes))
            assert got == want, (poison, k)
    # sanity: poison prunes at least one straddling candidate here
    k = 2
    assert len(list(_host(tables, k, False).scan(db.codes))) > \
        len(list(_host(tables, k, True).scan(db.codes)))


def test_multiword_state_and_overflow():
    """>64 concatenated pattern chars forces multiword carries; a tiny
    cap_hint exercises the overflow re-run."""
    rng = np.random.default_rng(11)
    db = _db(rng, 30000)
    pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=13))
            for _ in range(12)]  # 156 bits = 3 words
    _plant(db, pats, rng)
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    assert int(tables.lengths.sum()) > 64
    want = list(_xla(tables, 1).scan(db.codes))
    hs = HostShiftAnd(tables, k=1, poison_eos=True)
    assert hs.available()
    got = list(hs.scan(db.codes, cap_hint=1))  # force retry path
    assert got == want and want


def test_duplicate_and_short_patterns():
    """Duplicate patterns fan out as distinct registrations; length-1
    patterns work at k=0; length<=k patterns (threshold <= 0: the conv
    contract hits EVERYWHERE) make the host machine decline so the
    degenerate contract stays on the device path."""
    rng = np.random.default_rng(13)
    db = _db(rng, 3000, entries=3)
    pats = ["ACGT", "ACGT", "A", "GG"]
    ps = build_pattern_set(pats, rev_comp=False)
    tables = build_tables(ps, db, wc=False, textn=False)
    want = list(_xla(tables, 0).scan(db.codes))
    got = list(_host(tables, 0).scan(db.codes))
    assert got == want and want
    for k in (1, 2):
        hs = HostShiftAnd(tables, k=k, poison_eos=True)
        assert not hs.available()
        sc = ConvScanner(tables, k=k, use_fused=False)
        assert not sc._host_eligible(3000)


def test_gs_sparse_tables():
    """Gapped-seed-shaped tables: sparse accepting columns with don't-care
    gaps, lengths[p] = sampled count != window span (the _gs_engine
    construction, primer_match.py)."""
    rng = np.random.default_rng(19)
    db = _db(rng, 20000, entries=2)
    pats = ["ACGTACGTACGTACGTACGT"]
    _plant(db, pats, rng, copies=6)
    # hand-build a sparse table: sample columns 0,2,3,7,9,12 of the pattern
    from sequence_alignment_tools.ops.tables import PatternTables

    cols = [0, 2, 3, 7, 9, 12]
    tmax = 14
    alpha = db.alphabet_size
    match = np.zeros((2, tmax, alpha), dtype=bool)
    for j in cols:
        match[0, j, db.table.index(pats[0][j].encode())] = True
        # second row: same samples shifted right by one (leading gap)
        match[1, j + 1, db.table.index(pats[0][j].encode())] = True
    tables = PatternTables(
        match=match, lengths=np.array([len(cols)] * 2, np.int32),
        pat_codes=np.full((2, tmax), -1, np.int16),
        Lmax=tmax, alpha=alpha, eos_code=db.eos_code)
    for k in (0, 1):
        want = list(_xla(tables, k).scan(db.codes))
        hs = HostShiftAnd(tables, k=k, poison_eos=False)
        assert hs.available()
        got = list(hs.scan(db.codes))
        assert got == want and want, (k, len(got), len(want))


def test_state_budget_gate():
    """Pattern sets beyond the native state budget report unavailable and
    the scanner falls through to a device path."""
    rng = np.random.default_rng(17)
    db = _db(rng, 5000)
    pats = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=64))
            for _ in range(80)]  # 5120 bits > 4096
    ps = build_pattern_set(pats, rev_comp=False)
    tables = build_tables(ps, db, wc=False, textn=False)
    hs = HostShiftAnd(tables, k=0, poison_eos=False)
    assert not hs.available()
    sc = ConvScanner(tables, k=0, use_fused=False)
    assert not sc._host_eligible(5000)
    list(sc.scan(db.codes))  # falls through without error


def test_threaded_scan_matches_single_thread():
    """sat_shift_and_scan_mt (chunked with a (Lmax-1)-char warm-up
    halo) must emit the identical hit stream to the single-thread scan
    — planted hits straddling chunk boundaries and EOS resets
    included.  (The wrapper auto-routes to the threaded entry at
    n >= 1M.)"""
    import numpy as np

    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.ops.host_scan import HostShiftAnd
    from sequence_alignment_tools.ops.tables import build_tables

    rng = np.random.default_rng(8)
    n = (1 << 21) + 12345
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    table = b"ACGT\n"
    pats = ["ACGTTGCAACGT", "TTGACCAGTTGA"]
    enc = {p: np.array([table.index(c.encode()) for c in p], np.uint8)
           for p in pats}
    # hits around the likely chunk boundaries (min_chunk = 256K) and
    # EOS resets right before them
    for at in (100, (1 << 18) - 6, (1 << 18) + 3, (1 << 19) - 1,
               3 * (1 << 19), n - 13):
        codes[at : at + 12] = enc[pats[at % 2]]
    codes[(1 << 18) - 30] = 4  # EOS inside a halo window
    db = SeqDB(codes=codes, table=table, entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    ps = build_pattern_set(pats, rev_comp=True)
    t = build_tables(ps, db, wc=False, textn=False)
    for k in (0, 1):
        hs = HostShiftAnd(t, k=k, poison_eos=k > 0)
        if not hs.available():
            return
        got = list(hs.scan(codes))  # auto-routes to mt at n >= 1M
        # the same scan with the mt entry hidden = single-thread path
        hs2 = HostShiftAnd(t, k=k, poison_eos=k > 0)
        lib = hs2.lib

        class NoMT:
            def __getattr__(self, a):
                if a == "sat_shift_and_scan_mt":
                    raise AttributeError(a)
                return getattr(lib, a)

        hs2.lib = NoMT()
        want = list(hs2.scan(codes))
        assert got == want and len(got) >= 6
