"""Exact class-ENCODE bit-plane filter (round 5).

Wide-alphabet EXACT scans (the ``peptide_scan`` regime: ~20 live amino
acid classes, peptide_scan.cc driving the shared scan stack of
primer_match.cc:1114) pay one indicator plane per live class in the
microhit filter.  The
exact class-encode mode (``ConvScanner._exact_encode_cc``) groups live
codes into equivalence classes by accept-column equality, assigns each
a B-bit id (ids 1.., id 0 = dead/EOS), and scans B = ceil(log2(ncls+1))
bit planes with +/-1 weights: the margin peaks at the pattern's 1-bit
count iff every char matches exactly, so the filter is EXACT (any wrong
char loses >= 1), and ~20 passes become 5.

Pinned here:
- hit-for-hit parity with the XLA block path on a 20-class AA corpus
  (multi-entry: EOS boundaries recode to the dead id and are rejected
  structurally), with the mode asserted ENGAGED;
- mixed pattern lengths (distinct npos thresholds per pattern);
- SAT_EXACTCODE=0 restores the class planes with identical output;
- ineligible configs decline: plain DNA (< 6 live classes), k > 0, and
  non-singleton accept relations that don't factor through the
  column-equality quotient (IUPAC -w stays on the 4-bit base-mask
  superset mode, test_bitplanes.py).
"""

import os

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables

AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def aa_db(tmp_path_factory):
    rng = np.random.default_rng(11)
    seq = "".join(AA[i] for i in rng.integers(0, 20, size=90_000))
    path = tmp_path_factory.mktemp("aa") / "aa.fasta"
    with open(path, "w") as f:
        # three entries: EOS separators land INSIDE scan windows
        for e, (a, b) in enumerate(((0, 30_000), (30_000, 60_000),
                                    (60_000, 90_000))):
            f.write(">p%d\n" % e)
            s = seq[a:b]
            for i in range(0, len(s), 70):
                f.write(s[i : i + 70] + "\n")
    return SeqDB.from_fasta(str(path)), seq


def _scan(tables, codes, fused, mode=True):
    old = os.environ.get("SAT_EXACTCODE")
    os.environ["SAT_EXACTCODE"] = "1" if mode else "0"
    try:
        sc = ConvScanner(tables, k=0, use_fused=fused or None)
        sc.force_device = fused
        if fused:
            sc.use_fused = True
        sc.use_host = False
        return sorted(sc.scan(codes)), sc
    finally:
        if old is None:
            os.environ.pop("SAT_EXACTCODE", None)
        else:
            os.environ["SAT_EXACTCODE"] = old


def test_exactcode_parity_aa(aa_db):
    db, seq = aa_db
    # mixed lengths 7/9/12, drawn from the corpus (real hits exist),
    # plus one straddling an entry boundary (must NOT match: EOS)
    pats = [seq[i : i + 7 + (i // 9_000) % 3 * 2]
            for i in range(500, 85_000, 9_000)]
    pats.append(seq[29_995 : 30_007])
    ps = build_pattern_set(pats)
    t = build_tables(ps, db, wc=False, textn=False)
    codes = np.asarray(db.codes)
    got, sc = _scan(t, codes, fused=True, mode=True)
    bm = sc._bitplane_cc
    assert bm not in (False, None), "exact class-encode did not engage"
    assert bm["alpha_r"] == 32 and len(bm["classes"]) == 5
    want, _ = _scan(t, codes, fused=False, mode=False)
    assert got == want and want
    off, sc_off = _scan(t, codes, fused=True, mode=False)
    assert sc_off._bitplane_cc is None
    assert off == want


def test_exactcode_sharded_parity(aa_db):
    """The sharded fused pipeline consumes the SAME bit-mode weights as
    the single-chip dispatch (LUT recode host-side before sharding,
    halos filled with the dead id): 1 chip == 8 virtual chips on an AA
    exact config, with shard-boundary-straddling patterns planted."""
    import jax

    from sequence_alignment_tools.parallel.shard import (
        make_mesh,
        sharded_scan_hits,
    )

    db, seq = aa_db
    codes = np.asarray(db.codes)
    shard_len = -(-len(codes) // 8)
    pats = [seq[i : i + 9] for i in range(500, 85_000, 9_000)]
    for i in (1, 3, 5):  # windows straddling the 8-way shard edges
        s = i * shard_len - 4
        sub = db.decode(s, 9)
        if sub.isalpha():
            pats.append(sub)
    ps = build_pattern_set(pats)
    t = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(t, k=0, use_fused=True)
    sc.force_device = True
    sc.use_host = False
    want = sorted(sc.scan(codes))
    assert want and sc._bitplane_cc not in (False, None)
    mesh = make_mesh(jax.devices()[:8])
    got = sorted(sharded_scan_hits(sc, codes, mesh))
    assert got == want


def test_exactcode_sharded_stream_parity(aa_db):
    """The SERVING stream form (sharded_scan_stream, dispatch-ahead
    with background fetches) applies the same LUT recode per block:
    block-for-block parity with the single-chip scan on AA exact."""
    import jax

    from sequence_alignment_tools.parallel.shard import (
        make_mesh,
        sharded_scan_stream,
    )

    db, seq = aa_db
    codes = np.asarray(db.codes)
    pats = [seq[i : i + 9] for i in range(500, 85_000, 9_000)]
    ps = build_pattern_set(pats)
    t = build_tables(ps, db, wc=False, textn=False)
    blocks = [codes[:45_000], codes[45_000:]]
    sc = ConvScanner(t, k=0, use_fused=True)
    sc.force_device = True
    sc.use_host = False
    want = {i: sorted(sc.scan(b)) for i, b in enumerate(blocks)}
    assert any(want.values())
    mesh = make_mesh(jax.devices()[:8])
    sc2 = ConvScanner(t, k=0, use_fused=True)
    sc2.force_device = True
    sc2.use_host = False
    got = {i: sorted(h) for i, h in
           sharded_scan_stream(sc2, iter(blocks), mesh)}
    assert got == want
    assert sc2._bitplane_cc not in (False, None)


def test_wide_bitplane_sharded_parity():
    """The IUPAC 4-bit base-mask mode rides the sharded pipeline too
    (it previously declined under a mesh to the class planes)."""
    import jax

    from sequence_alignment_tools.parallel.shard import (
        make_mesh,
        sharded_scan_hits,
    )

    rng = np.random.default_rng(7)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    base = rng.integers(0, 4, size=60_000)
    amb = rng.random(60_000) < 0.03
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    seq = table[base].tobytes().decode()
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".fasta",
                                     delete=False) as f:
        f.write(">w\n" + seq + "\n")
        path = f.name
    db = SeqDB.from_fasta(path)
    pats = [seq[i : i + 12] for i in range(500, 55_000, 6_000)]
    pats.append("ACGRYTNNSWKT")
    ps = build_pattern_set(pats, rev_comp=True)
    t = build_tables(ps, db, wc=True, textn=False)
    codes = np.asarray(db.codes)
    sc = ConvScanner(t, k=0, use_fused=True)
    sc.force_device = True
    sc.use_host = False
    want = sorted(sc.scan(codes))
    assert want and sc._bitplane_cc not in (False, None)
    mesh = make_mesh(jax.devices()[:8])
    got = sorted(sharded_scan_hits(sc, codes, mesh))
    assert got == want


def test_exactcode_declines(aa_db):
    db, seq = aa_db
    # k > 0 declines
    ps = build_pattern_set([seq[10:25]])
    t = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(t, k=1)
    assert sc._bitplane_mode() is None
    # plain DNA (< 6 live classes): the class planes remain
    rng = np.random.default_rng(5)
    dna = "".join("ACGT"[i] for i in rng.integers(0, 4, size=4096))
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".fasta",
                                     delete=False) as f:
        f.write(">d\n" + dna + "\n")
        dpath = f.name
    ddb = SeqDB.from_fasta(dpath)
    dps = build_pattern_set([dna[10:25], dna[40:58]], rev_comp=True)
    dt = build_tables(dps, ddb, wc=False, textn=False)
    dsc = ConvScanner(dt, k=0)
    assert dsc._bitplane_mode() is None
