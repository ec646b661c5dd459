"""Wide-alphabet IUPAC bit-plane filter mode (round 5).

The -w wildcard scan's microhit filter reads one indicator plane per
live alphabet class (~14 for the 15-symbol IUPAC alphabet).  The
bit-plane mode (``ConvScanner._bitplane_mode``) recodes the resident
text to 4-bit base masks and scans 4 bit planes instead — a SUPERSET
filter (margins count base-set intersections) resolved by the exact
in-pipeline rescore, reindexed over mask values.

Pinned here:
- hit-for-hit parity with the XLA block path on a 15-symbol corpus with
  ambiguity codes in both text and patterns (incl. the reference's
  COMPATIBLE quirks, iupac.py:18-37 — e.g. T accepting V — which force
  the minimal-widening path);
- the mode actually ENGAGES for the wide config (else this file would
  silently test the class path);
- SAT_BITPLANES=0 restores the class planes with identical output;
- ineligible configs (plain DNA, k>0) decline to class planes.
"""

import os

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables


@pytest.fixture(scope="module")
def wide_db(tmp_path_factory):
    rng = np.random.default_rng(7)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    base = rng.integers(0, 4, size=120_000)
    amb = rng.random(120_000) < 0.03
    base[amb] = rng.integers(4, 15, size=int(amb.sum()))
    seq = table[base].tobytes().decode()
    path = tmp_path_factory.mktemp("wide") / "wide.fasta"
    with open(path, "w") as f:
        f.write(">w\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i : i + 70] + "\n")
    return SeqDB.from_fasta(str(path)), seq


def _scan(tables, codes, fused, bitplanes=True):
    old = os.environ.get("SAT_BITPLANES")
    os.environ["SAT_BITPLANES"] = "1" if bitplanes else "0"
    try:
        sc = ConvScanner(tables, k=0, use_fused=fused or None)
        sc.force_device = fused
        if fused:
            sc.use_fused = True
        sc.use_host = False
        out = sorted(sc.scan(codes))
        return out, sc
    finally:
        if old is None:
            os.environ.pop("SAT_BITPLANES", None)
        else:
            os.environ["SAT_BITPLANES"] = old


def test_bitplane_parity_wide_wc(wide_db):
    db, seq = wide_db
    # patterns drawn from the corpus (so ambiguity codes land in
    # patterns too) + a hand-built heavy-wildcard pattern; T positions
    # exercise the COMPATIBLE["T"]-lists-V quirk widening
    pats = [seq[i : i + 12] for i in range(500, 110_000, 9_000)][:12]
    pats.append("ACGRYTNNSWKT")
    ps = build_pattern_set(pats, rev_comp=True)
    t = build_tables(ps, db, wc=True, textn=False)
    codes = np.asarray(db.codes)
    got, sc = _scan(t, codes, fused=True, bitplanes=True)
    assert sc._bitplane_cc not in (False, None), \
        "bit-plane mode did not engage for the wide -w config"
    want, _ = _scan(t, codes, fused=False, bitplanes=True)
    assert got == want
    off, sc_off = _scan(t, codes, fused=True, bitplanes=False)
    assert sc_off._bitplane_cc is None
    assert off == want


def test_bitplane_dead_code_mask_alias():
    """DEAD text codes sharing a 4-bit base mask with a LIVE code must
    not alias it through the recode: U's CONTAINS mask equals T's (8),
    so if any code is accepted nowhere (dead) while its mask collides
    with a live code, recoding it to that mask would make the
    mask-space rescore score it AS the live code.  Text carries U and
    unusual letters; parity vs the XLA block path pins the behavior
    whatever the accept table says about them."""
    rng = np.random.default_rng(17)
    table = np.frombuffer(b"ACGTRYSWKMBDHVNU", dtype=np.uint8)
    base = rng.integers(0, 4, size=100_000)
    amb = rng.random(100_000) < 0.05
    base[amb] = rng.integers(4, 16, size=int(amb.sum()))
    seq = table[base].tobytes().decode()
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".fasta",
                                     delete=False) as f:
        f.write(">u\n" + seq + "\n")
        path = f.name
    db = SeqDB.from_fasta(path)
    # patterns avoid every char whose COMPATIBLE row accepts text-U
    # (no literal T/U/B/D/H/N/...), so U stays DEAD — while K accepts T,
    # whose 4-bit mask U shares: the pre-fix recode scored text-U as T
    # at K positions (COMPATIBLE['K'] = 'GTKBDN' excludes U)
    kpats = []
    for i in range(500, 90_000, 8_000):
        p = "".join(ch if ch in "ACG" else "K"
                    for ch in seq[i : i + 12])
        kpats.append(p)
    ps = build_pattern_set(kpats, rev_comp=False)
    t = build_tables(ps, db, wc=True, textn=False)
    codes = np.asarray(db.codes)
    got, sc = _scan(t, codes, fused=True, bitplanes=True)
    assert sc._bitplane_cc not in (False, None), \
        "mode declined: the alias case is untested"
    acc = np.asarray(t.match)
    ucode = list(db.table).index(ord("U"))
    assert not acc[:, :, ucode].any(), "U is live: alias case untested"
    want, _ = _scan(t, codes, fused=False, bitplanes=True)
    assert got == want


def test_bitplane_declines_plain_dna():
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=4096))
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".fasta",
                                     delete=False) as f:
        f.write(">d\n" + seq + "\n")
        path = f.name
    db = SeqDB.from_fasta(path)
    ps = build_pattern_set([seq[10:25], seq[100:118]], rev_comp=True)
    t = build_tables(ps, db, wc=False, textn=False)
    # plain DNA keeps the class planes
    sc = ConvScanner(t, k=0)
    assert sc._bitplane_mode() is None  # < 6 live classes
    ps2 = build_pattern_set([seq[10:25]], rev_comp=True)
    t2 = build_tables(ps2, db, wc=True, textn=False)
    sc2 = ConvScanner(t2, k=1)
    assert sc2._bitplane_mode() is None  # k > 0
