"""Large pattern sets (P > 2048): the pattern-blocked fused-pipeline scan
(ops.conv_scan.ConvScanner._scan_pblocked) must reproduce the XLA block
path's full (end, pid, mism) stream — the regime of xmers phase-1 batches
(xmers.cc:821, -b 50000) and nrdb's one-seed-per-sequence registration
(nrdb.cc:196-220)."""

import numpy as np

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import PatternSet
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables


def _big_problem(P=2200, n=60000, L=16, seed=11, k=0):
    """Patterns drawn FROM the text (every one hits at least once), plus
    boundary-straddling duplicates."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    text = "".join("ACGT"[c] for c in codes)
    pats = []
    step = (n - L) // P
    for i in range(P):
        pats.append(text[i * step : i * step + L])
    db = SeqDB(
        codes=codes, table=b"ACGT\n",
        entry_starts=np.array([0]), entry_lengths=np.array([n]),
        headers=["x"],
    )
    ps = PatternSet()
    ps.patterns = [""] + pats
    ps.esb = [0] * (P + 1)
    ps.eeb = [0] * (P + 1)
    ps.n_forward = P
    tables = build_tables(ps, db, wc=False, textn=False)
    return db, tables


def test_pblocked_matches_xla_exact():
    db, tables = _big_problem()
    assert tables.P > ConvScanner._PBLOCK

    ref = ConvScanner(tables, k=0, use_fused=False)
    ref.use_host = False
    want = sorted(ref.scan(db.codes))
    assert len(want) >= tables.P  # every pattern occurs

    sc = ConvScanner(tables, k=0, use_fused=True)
    sc.force_device = True
    sc.use_host = False
    got_stream = list(sc.scan(db.codes))
    assert sorted(got_stream) == want
    # contract: globally ordered by (window_start, pattern)
    keyed = [(e - int(tables.lengths[p]), p) for e, p, _ in got_stream]
    assert keyed == sorted(keyed)
    # the scan really went through the pattern-blocked path
    assert sc._pblock_subs_c is not None and len(sc._pblock_subs_c) == 2


def test_pblocked_matches_xla_k1():
    db, tables = _big_problem(P=2100, n=30000)
    ref = ConvScanner(tables, k=1, poison_eos=True, use_fused=False)
    ref.use_host = False
    want = sorted(ref.scan(db.codes))

    sc = ConvScanner(tables, k=1, poison_eos=True, use_fused=True)
    sc.force_device = True
    sc.use_host = False
    got = sorted(sc.scan(db.codes))
    assert got == want and want


def test_pblocked_scan_stream():
    db, tables = _big_problem(P=2100, n=40000)
    codes = np.asarray(db.codes)
    blocks = [codes[:17000], codes[17000:]]

    ref = ConvScanner(tables, k=0, use_fused=False)
    ref.use_host = False
    want = {i: sorted(ref.scan(b)) for i, b in enumerate(blocks)}

    sc = ConvScanner(tables, k=0, use_fused=True)
    sc.force_device = True
    sc.use_host = False
    got = {i: sorted(h) for i, h in sc.scan_stream(iter(blocks))}
    assert got == want


def test_long_pattern_notice_in_verbose_report():
    """Lmax > 128 (past the fused filter) is announced in the strategy report
    rather than silently rerouted (select-announcement style)."""
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        select_report,
    )

    db, _ = _big_problem(P=4, n=4000, L=16)
    long_pat = "".join("ACGT"[c] for c in np.asarray(db.codes[:200]))
    ps = build_pattern_set([long_pat])
    lines = select_report(db, ps, k=0, wc=False, textn=False, seedlen=0,
                          node=0, indels=True, dna_mut=False)
    assert any("max length 200 > 128" in l for l in lines), lines
    # short sets stay announcement-free
    ps2 = build_pattern_set([long_pat[:20]])
    lines2 = select_report(db, ps2, k=0, wc=False, textn=False, seedlen=0,
                           node=0, indels=True, dna_mut=False)
    assert not any("fused scan filter" in l for l in lines2)
