"""SellersScanner vs a brute-force NumPy Sellers DP oracle.

Pins the k-edit candidate semantics the engines build on
(``shift_and_inexact.cc:249-350`` equivalence): per-boundary min edit
distance with EOS gating, across indels on/off, multiple k, block
boundaries (halo deferral), and cap overflow retries."""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.sellers import SellersScanner
from sequence_alignment_tools.ops.tables import build_tables


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    rng = np.random.default_rng(7)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    p = tmp_path_factory.mktemp("sellers") / "db.fasta"
    p.write_text(">a\n" + seq[:2700] + "\n>b\n" + seq[2700:] + "\n")
    db = SeqDB.from_fasta(str(p))
    ps = build_pattern_set(
        ["ACGTACGTAAG", "TTGACCATGA", "GGGTTTCCA"], rev_comp=True)
    return db, build_tables(ps, db, wc=False, textn=False)


def _oracle(codes, tables, k, indels):
    codes = codes.astype(int)
    eos = tables.eos_code
    n = len(codes)
    INF = k + 1
    run = np.zeros(n, dtype=int)
    last = -1
    for i in range(n):
        if codes[i] == eos:
            last = i
        run[i] = i - last
    at_eos = codes == eos
    exp = []
    for pi in range(tables.P):
        L = int(tables.lengths[pi])
        D = np.zeros(n, dtype=int)
        m = tables.match[pi]
        for j in range(L):
            subc = np.where(m[j][codes], 0, 1)
            diag = np.concatenate([[INF], D[:-1]])
            base = np.where(at_eos, INF, diag + subc)
            if indels:
                base = np.minimum(base, np.where(at_eos, INF, D + 1))
            base = np.minimum(base, INF)
            out = base.copy()
            if indels:
                for t in range(1, k + 1):
                    sh = np.concatenate([[INF] * t, base[:-t]]) + t
                    out = np.minimum(out, np.where(run >= t, sh, INF))
            D = np.minimum(out, INF)
        for i in np.nonzero(D <= k)[0]:
            exp.append((i + 1, pi, int(D[i])))
    return sorted(exp)


@pytest.mark.parametrize("k,indels,block,cap", [
    (1, True, 1500, 4096),
    (2, True, 1000, 64),   # cap 64 forces the overflow-retry path
    (1, False, 1500, 4096),
    (3, True, 7000, 256),  # single block covering the whole db
])
def test_sellers_oracle(small_db, k, indels, block, cap):
    db, tables = small_db
    sc = SellersScanner(tables, k=k, indels=indels, block=block, cap=cap)
    got = sorted(sc.scan(db.codes))
    assert got == _oracle(db.codes, tables, k, indels)
