"""The microhit filter (ops.microhit.microhits) against a plain numpy
evaluation of the same margins and against the native host shift-and.

Each scan mode feeds the filter its own weight form: the exact DNA scan
(folded and unfolded class planes), the -K 1 poison k-mismatch scan, the
IUPAC wildcard bit-plane mode and the peptide class-encode mode.  Both
emit modes must equal the numpy margins exactly, cover every host hit,
and — where the weights are exact — reproduce the host hit set position
for position.
"""

import os

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.host_scan import HostShiftAnd
from sequence_alignment_tools.ops.microhit import (BITCLS, filter_weights,
                                                   microhits)
from sequence_alignment_tools.ops.tables import build_tables

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")
MB = 32


def _db(table: bytes, base, path):
    seq = np.frombuffer(table, np.uint8)[base].tobytes().decode()
    with open(path, "w") as f:
        f.write(">a first entry\n" + seq[: len(seq) // 2] + "\n")
        f.write(">b second entry\n" + seq[len(seq) // 2 :] + "\n")
    return SeqDB.from_fasta(str(path)), seq


def _config(mode, tmp_path):
    """(codes the filter reads, W, thr, classes, pad, tables, k, poison,
    exact) for one scan mode; ``exact`` = margins >= 0 are exactly the
    host hits."""
    rng = np.random.default_rng(3)
    if mode in ("exact", "K1"):
        db, seq = _db(b"ACGT", rng.integers(0, 4, size=40_000),
                      tmp_path / "dna.fasta")
        pats = [ln.strip() for ln in open(PAT) if ln.strip()]
        pats += [seq[i : i + 15] for i in (1000, 9000, 25_000)]
        t = build_tables(build_pattern_set(pats, rev_comp=True), db,
                         wc=False, textn=False)
        k, poison = (0, False) if mode == "exact" else (1, True)
        W, thr, classes = filter_weights(t, k, poison, fold=False)
        return (np.asarray(db.codes), W, thr, classes, max(t.eos_code, 0),
                t, k, poison, True)
    if mode == "iupac":
        base = rng.integers(0, 4, size=40_000)
        amb = rng.random(40_000) < 0.03
        base[amb] = rng.integers(4, 15, size=int(amb.sum()))
        db, seq = _db(b"ACGTRYSWKMBDHVN", base, tmp_path / "wide.fasta")
        pats = [seq[i : i + 12] for i in range(500, 38_000, 4_000)]
        pats.append("ACGRYTNNSWKT")
        t = build_tables(build_pattern_set(pats, rev_comp=True), db,
                         wc=True, textn=False)
        exact = False
    else:  # classenc
        aa = b"ACDEFGHIKLMNPQRSTVWY"
        db, seq = _db(aa, rng.integers(0, 20, size=40_000),
                      tmp_path / "aa.fasta")
        pats = [seq[i : i + 9] for i in range(300, 38_000, 3_000)]
        t = build_tables(build_pattern_set(pats), db, wc=False,
                         textn=False)
        exact = True
    sc = ConvScanner(t, k=0)
    bm = sc._bitplane_mode()
    assert bm is not None, "bit-plane mode did not engage"
    lut = np.asarray(bm["lut"])
    codes = lut[np.asarray(db.codes)]
    return (codes, np.asarray(bm["W"]), np.asarray(bm["thr"]),
            bm["classes"], bm["eos_r"], t, 0, False, exact)


def _margins_np(codes, W, thr, classes, pad):
    """Plain numpy margins [N, P] over window starts 0..N-1."""
    Lmax, _nc, P = W.shape
    n = len(codes)
    N = -(-n // MB) * MB
    ext = np.full(N + Lmax - 1, pad, np.int64)
    ext[:n] = codes
    m = np.broadcast_to(-thr.astype(np.int64), (N, P)).copy()
    for j in range(Lmax):
        c = ext[j : j + N]
        for ci, cls in enumerate(classes):
            if cls >= BITCLS:
                plane = ((c >> (cls - BITCLS)) & 1) > 0
            else:
                plane = c == cls
            m += np.where(plane[:, None], W[j, ci][None, :], 0)
    return m


@pytest.mark.parametrize("emit", ["occupancy", "pos"])
@pytest.mark.parametrize("mode", ["exact", "K1", "iupac", "classenc"])
def test_microhits_match_numpy_and_host(mode, emit, tmp_path):
    import jax.numpy as jnp

    codes, W, thr, classes, pad, t, k, poison, exact = _config(
        mode, tmp_path)
    got = np.asarray(microhits(
        jnp.asarray(codes, jnp.uint8), jnp.asarray(W), jnp.asarray(thr),
        classes=classes, MB=MB, pad=pad, emit=emit))
    m = _margins_np(codes, W, thr, classes, pad)
    N = m.shape[0]
    hit = m >= 0
    if emit == "occupancy":
        want = hit.reshape(N // MB, MB * m.shape[1]).any(axis=1)
    else:
        cnt = hit.sum(axis=1)
        top = np.where(hit, np.arange(m.shape[1])[None, :], -1).max(axis=1)
        want = np.where(cnt > 0, (top << 8) | np.minimum(cnt, 255), -256)
    np.testing.assert_array_equal(got[:len(want)], want)

    host = HostShiftAnd(t, k, poison)
    assert host.available()
    hits = list(host.scan(np.asarray(codes if mode in ("exact", "K1")
                                     else _orig_codes(t, tmp_path, mode))))
    assert hits
    starts = np.asarray([e - t.lengths[p] for e, p, _m in hits])
    if emit == "occupancy":
        assert got[starts // MB].all()
    else:
        assert (got[starts] >= 0).all()
        if exact:
            by_pos = {}
            for s, (_e, p, _m) in zip(starts.tolist(), hits):
                by_pos.setdefault(s, []).append(p)
            live = np.flatnonzero(got[: len(codes)] >= 0)
            assert set(live.tolist()) == set(by_pos)
            for s, ps in by_pos.items():
                assert got[s] & 255 == len(ps) and got[s] >> 8 == max(ps)


def _orig_codes(t, tmp_path, mode):
    """The un-recoded database codes of a bit-plane config (the host
    machine scans the original alphabet)."""
    name = {"iupac": "wide.fasta", "classenc": "aa.fasta"}[mode]
    return np.asarray(SeqDB.from_fasta(str(tmp_path / name)).codes)
