"""Native threaded mer-hash census (shift_and.cpp::sat_mer_scan): the
huge-P exact regime (hash_table.cc:144-226 / the reference's xmers mer
pipeline).  Candidate-stream parity with the numpy radix census across
EOS boundaries, duplicate patterns (chain fan-out), mixed lengths, and
hash-collision pressure."""

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.tables import build_tables


def _mk(n, seed, eos_at=()):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    for s in eos_at:
        codes[s] = 4
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    return db, codes


def _pair(tables, codes, n):
    nat = ConvScanner(tables, k=0, use_fused=False)
    if not nat._mer_lib_ok():
        pytest.skip("native toolchain unavailable")
    got = list(nat._scan_radix(codes))
    ref = ConvScanner(tables, k=0, use_fused=False)
    ref._mer_native = lambda *a, **k: None  # pin the numpy census
    want = list(ref._scan_radix(codes))
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_mer_scan_matches_numpy_census(seed):
    n = 1 << 20
    db, codes = _mk(n, seed, eos_at=(5000, 400_000, 900_000))
    text = "".join("ACGT"[c] if c < 4 else "A" for c in codes[:300_000])
    pats = [text[i * 41 : i * 41 + 14] for i in range(1500)]
    pats += [text[i * 67 : i * 67 + 22] for i in range(1500)]
    pats = list(dict.fromkeys(p for p in pats if len(p) >= 14))
    pats += pats[:3]  # duplicate patterns: chain fan-out at one code
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    got, want = _pair(tables, codes, n)
    assert got == want and len(want) > len(pats)


def test_mer_scan_window_straddles_eos_never_hits():
    """A window containing the EOS digit can never match (EOS is a live
    base-alpha digit no pattern contains) — plant a pattern right at an
    entry boundary and pin that only the in-entry occurrence fires."""
    n = 1 << 19
    db, codes = _mk(n, 7, eos_at=(1000,))
    pat = "ACGTACGTACGTAC"
    pc = np.array([b"ACGT".index(c.encode()) for c in pat], np.uint8)
    codes[993 : 993 + 14] = pc  # overwrites the EOS at 1000
    codes[1000] = 4             # re-break it: straddling window
    codes[2000 : 2000 + 14] = pc
    ps = build_pattern_set([pat] * 300, rev_comp=False)  # chain depth 300
    tables = build_tables(ps, db, wc=False, textn=False)
    got, want = _pair(tables, codes, n)
    assert got == want
    starts = {e - 14 for e, _p, _m in got}
    assert 2000 in starts and 993 not in starts


def test_huge_p_auto_routes_to_census():
    """P > _PBLOCK exact literal sets take the census route in scan()
    (the dense correlation is FLOP-bound there)."""
    n = 1 << 19
    db, codes = _mk(n, 9)
    text = "".join("ACGT"[c] for c in codes[:200_000])
    pats = list(dict.fromkeys(text[i * 31 : i * 31 + 16]
                              for i in range(1300)))
    ps = build_pattern_set(pats, rev_comp=True)  # P > 2048
    tables = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(tables, k=0, use_fused=False)
    assert tables.P > sc._PBLOCK
    hits = list(sc.scan(codes))
    ref = ConvScanner(tables, k=0, use_fused=False)
    ref._mer_native = lambda *a, **k: None
    assert hits == list(ref._scan_radix(codes)) and hits
