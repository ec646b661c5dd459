"""The device k-edit scan (ops.sellers.SellersScanner.scan_pairs): the
whole-array XLA Sellers scan over large blocks must produce the exact
candidate SET of the small-block DP and of the native Sellers row machine
(shift_and_inexact.cc:249-350 semantics), including EOS gating,
multi-pattern boundaries, block halos and cap overflow."""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.sellers import SellersScanner
from sequence_alignment_tools.ops.tables import build_tables


def _mk(n, seed=0, entries=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    # entry boundaries: EOS sprinkled in (exercises the nrun gates)
    starts = sorted(rng.integers(1, n - 1, size=entries - 1).tolist())
    for s in starts:
        codes[s] = 4
    db = SeqDB(codes=codes, table=b"ACGT\n",
               entry_starts=np.array([0]), entry_lengths=np.array([n]),
               headers=["x"])
    return db


@pytest.mark.parametrize("seed,k,indels", [(0, 1, True), (1, 2, True),
                                           (2, 2, True), (3, 1, True)])
def test_kernel_matches_block_dp(seed, k, indels):
    n = 3 * (1 << 14) + 777  # partial trailing block
    db = _mk(n, seed=seed)
    codes = np.asarray(db.codes)
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:6000])
    pats = [text[100:118], text[3000:3020], text[5000:5015]]
    # plant a near-miss (1 edit) and an exact dup to force multi cases
    pats.append(pats[0][:10] + "T" + pats[0][11:])
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)

    ref = SellersScanner(tables, k=k, indels=indels, block=1 << 16)
    want = sorted((e, p) for e, p, _ in ref.scan(codes))

    sc = SellersScanner(tables, k=k, indels=indels)
    sc.force_device = True
    sc._PAIRS_BLOCK = 1 << 14  # several blocks, one partial
    assert sc.device_available(n)
    ends, pids = sc.scan_pairs(codes)
    got = sorted(zip(ends.tolist(), pids.tolist()))
    assert got == want and want
    host = SellersScanner(tables, k=k, indels=indels)
    if host._host_eligible(n):  # the native row machine agrees
        he, hp = host.host_pairs(codes)
        assert sorted(zip(he.tolist(), hp.tolist())) == want


def test_kernel_overflow_rows_escape():
    """A poly-A region floods one block with candidates past the
    default cap: the cap grows and the candidate set is unchanged."""
    SEG = 4096
    n = 8 * SEG
    db = _mk(n, seed=9, entries=1)
    codes = np.asarray(db.codes)
    codes[SEG : SEG + 2000] = 0  # poly-A run inside segment row 1
    ps = build_pattern_set(["AAAAAAAAAA"])
    tables = build_tables(ps, db, wc=False, textn=False)

    ref = SellersScanner(tables, k=1, indels=True, block=1 << 16)
    want = sorted((e, p) for e, p, _ in ref.scan(codes))

    sc = SellersScanner(tables, k=1, indels=True, cap=64)
    sc.force_device = True
    ends, pids = sc.scan_pairs(codes)
    assert sc.cap > 64
    got = sorted(zip(ends.tolist(), pids.tolist()))
    assert got == want and len(want) > 1500
