"""Native k-edit row machine (ops.host_scan.HostSellers): candidate-set
and mindist parity with the XLA Sellers block DP
(shift_and_inexact.cc:265-315 semantics — the level sets of the Sellers
semi-global DP), including EOS gating, IUPAC classes, and the
free-start / prefix-deletion INIT rows."""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.host_scan import HostSellers
from sequence_alignment_tools.ops.sellers import SellersScanner
from sequence_alignment_tools.ops.tables import build_tables


def _mk(n, seed=0, entries=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for s in sorted(rng.integers(1, n - 1, size=entries - 1).tolist()):
        codes[s] = 4
    db = SeqDB(codes=codes, table=b"ACGT\n",
               entry_starts=np.array([0]), entry_lengths=np.array([n]),
               headers=["x"])
    return db


@pytest.mark.parametrize("seed,k,wc", [(0, 1, False), (1, 2, False),
                                       (2, 2, True), (3, 3, False),
                                       (4, 1, True)])
def test_host_sellers_matches_block_dp(seed, k, wc):
    n = 40_000
    db = _mk(n, seed=seed)
    codes = np.asarray(db.codes)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:9000])
    pats = [text[100:118], text[3000:3020], text[5000:5015]]
    pats.append(pats[0][:10] + "T" + pats[0][11:])  # planted 1-edit
    if wc:
        pats.append(text[7000:7008] + "N" + text[7009:7016])
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=wc, textn=False)

    ref = SellersScanner(tables, k=k, indels=True, block=1 << 14)
    want = sorted((e, p, d) for e, p, d in ref.scan(codes))

    hs = HostSellers(tables, k)
    assert hs.available()
    ends, pids, mism = hs.pairs(codes)
    got = sorted(zip(ends.tolist(), pids.tolist(), mism.tolist()))
    assert got == want and want


def test_host_sellers_multiword_state():
    """> 64 state bits (multi-word carry chains across all three shifted
    terms) and a pattern straddling a word boundary."""
    n = 20_000
    db = _mk(n, seed=7, entries=2)
    codes = np.asarray(db.codes)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:9000])
    pats = [text[i * 500 : i * 500 + 17] for i in range(12)]
    ps = build_pattern_set(pats, rev_comp=False)
    tables = build_tables(ps, db, wc=False, textn=False)

    ref = SellersScanner(tables, k=2, indels=True, block=1 << 14)
    want = sorted((e, p, d) for e, p, d in ref.scan(codes))

    hs = HostSellers(tables, 2)
    ends, pids, mism = hs.pairs(codes)
    got = sorted(zip(ends.tolist(), pids.tolist(), mism.tolist()))
    assert got == want and len(want) > 12


def test_filter_engine_host_route_parity():
    """The filter engine's auto host route (one-shot posture) emits the
    byte-identical stream of the pinned device/XLA route."""
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    n = 30_000
    db = _mk(n, seed=11)
    codes = np.asarray(db.codes)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:9000])
    pats = [text[100:118], text[4000:4018]]
    pats.append(pats[0][:9] + "G" + pats[0][10:])
    ps = build_pattern_set(pats, rev_comp=True)

    m_host = PrimerMatchModel(db, ps, k=2, indels=True)
    m_host.engine = "filter"
    sc = m_host._filter_ctx()[0]
    assert sc._host_eligible(n)
    got = list(m_host.engine_hits())

    m_dev = PrimerMatchModel(db, ps, k=2, indels=True)
    m_dev.engine = "filter"
    m_dev.use_host = False
    want = list(m_dev.engine_hits())
    assert got == want and want
