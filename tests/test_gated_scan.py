"""Fused gated k>0 pipeline (seed scan + extension gate on device) vs the
host engine path — output must be IDENTICAL: the gate is a superset filter
(ops/gate.py docstring proof) and the exact native extension decides, so the
engines' hit streams cannot differ.  Forced onto the CPU here; the same
route runs on the GPU."""

import os
import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.models.primer_match import PrimerMatchModel

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")


def _mutate(rng, pat: str, nmut: int, indels: bool) -> str:
    s = list(pat)
    for _ in range(nmut):
        op = rng.integers(0, 3) if indels else 0
        i = int(rng.integers(0, len(s)))
        if op == 0:
            s[i] = "ACGT"[int(rng.integers(0, 4))]
        elif op == 1 and len(s) > 4:
            del s[i]
        else:
            s.insert(i, "ACGT"[int(rng.integers(0, 4))])
    return "".join(s)


@pytest.fixture(scope="module")
def planted_db():
    rng = np.random.default_rng(23)
    n = 60000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    table = b"ACGT\n"
    pats = [ln.strip() for ln in open(PAT)
            if ln.strip()]
    db = SeqDB(
        codes=codes, table=table,
        entry_starts=np.array([0]), entry_lengths=np.array([n]),
        headers=["e1"],
    )

    def plant(at, s):
        for j, ch in enumerate(s):
            if at + j < n:
                db.codes[at + j] = table.index(ch.encode())

    slot = 300
    for i, p in enumerate(pats):
        plant(slot, p)
        slot += 700
        plant(slot, _mutate(rng, p, 1, True))
        slot += 700
        plant(slot, _mutate(rng, p, 2, True))
        slot += 700
        plant(slot, _mutate(rng, p, 1, False))
        slot += 700
    # adjacent duplicates (the 2k dedup window) and an end-straddler
    plant(41000, pats[0])
    plant(41000 + len(pats[0]) + 1, pats[0])
    plant(n - len(pats[0]) + 3, pats[0])
    return db, pats


@pytest.mark.parametrize("engine,k,indels", [
    ("halves", 1, True),
    ("halves", 2, True),
    ("halves", 1, False),
    ("halves", 2, False),
    ("bases", 1, True),
    ("bases", 2, True),
])
def test_gated_matches_host_engine(planted_db, engine, k, indels):
    db, pats = planted_db
    ps = build_pattern_set(pats, rev_comp=True)
    if engine == "bases":
        # exact_bases needs esb/eeb constraints to pick its seeds
        for pid in range(1, ps.n_total + 1):
            if pid % 2:
                ps.esb[pid] = max(len(ps.pattern(pid)) - k - 3, 1)
            else:
                ps.eeb[pid] = max(len(ps.pattern(pid)) - k - 3, 1)
    node = {"halves": 11, "bases": 8}[engine]
    host = PrimerMatchModel(db, ps, k=k, node=node, indels=indels)
    want = list(host.engine_hits())
    gated = PrimerMatchModel(db, ps, k=k, node=node, indels=indels)
    gated.force_device = True
    got = list(gated.engine_hits())
    assert got == want
    assert len(want) >= 10


def test_gate_superset_fuzz(planted_db):
    """Direct superset check: wherever the exact batched extension says
    ok, the device gate must say ok too (the converse may differ — the
    gate ignores constraints and charges every edit cost 1)."""
    from sequence_alignment_tools.engine.extend import (
        BatchSeedExtender, Extender)
    from sequence_alignment_tools.ops.gate import ExtendGate, GateTables

    import jax.numpy as jnp

    db, pats = planted_db
    rng = np.random.default_rng(7)
    for k, indels in [(1, True), (2, True), (1, False)]:
        seeds = [p[: len(p) // 2] for p in pats[:6]]
        exts = [p[len(p) // 2 :] for p in pats[:6]]
        S = len(seeds)
        # half lmatch, half rmatch geometry
        dirs = np.where(np.arange(S) % 2 == 0, 1, -1).astype(np.int32)
        geomB = np.where(dirs < 0,
                         [len(s) for s in seeds], 0).astype(np.int32)
        geomA = np.asarray(
            [len(seeds[i]) + len(exts[i]) + k for i in range(S)],
            np.int32) * (dirs < 0)
        la = np.zeros(S, np.int32)
        ra = np.zeros(S, np.int32)
        ext = Extender(k, "\n", False, False, indels, False)
        batch = BatchSeedExtender(ext, db, dirs, exts, la, ra, geomA,
                                  geomB)
        gate = ExtendGate(
            GateTables.from_seed_meta(db, exts, dirs, geomB, k,
                                      k if indels else 0, False, False),
            indels)
        C = 500
        anchors = rng.integers(20, len(db.codes) - 20, C).astype(np.int64)
        sids = rng.integers(0, S, C).astype(np.int32)
        ok_true, _, _ = batch(anchors, sids)
        ok_gate = np.asarray(
            gate(jnp.asarray(db.codes), anchors, sids))
        missed = ok_true & ~ok_gate
        assert not missed.any(), (
            f"k={k} indels={indels}: gate lost "
            f"{missed.sum()} true-ok candidates")


def test_wpack_eos_adjacent_hits_exact():
    """Hits whose extension window touches an entry boundary resolve
    exactly — engine output identical to the XLA oracle when matches sit
    immediately before/after EOS separators."""
    import numpy as np

    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    rng = np.random.default_rng(17)
    n = 1 << 18
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    text = "".join("ACGT"[c] for c in codes[:40000])
    pats = [text[100:120], text[9000:9018]]
    # entry boundaries RIGHT at pattern edges: EOS immediately after a
    # planted occurrence, and immediately before another
    pc = [np.asarray([b"ACGT".index(ch.encode()) for ch in p], np.uint8)
          for p in pats]
    codes[30000 : 30000 + 20] = pc[0]
    codes[30020] = 4  # EOS right after
    codes[31000] = 4  # EOS right before
    codes[31001 : 31001 + 18] = pc[1]
    # and one pattern SPLIT by an EOS (must NOT match)
    codes[32000 : 32000 + 20] = pc[0]
    codes[32010] = 4
    ps = build_pattern_set(pats, rev_comp=True)
    m = PrimerMatchModel(db, ps, k=1)
    m.use_host = False
    sc = m._halves_ctx()[1]
    sc.force_device = True
    got = sorted(m.engine_hits())

    m2 = PrimerMatchModel(db, ps, k=1)
    m2.use_host = False
    o2 = m2._halves_ctx()[1]
    o2.use_fused = False
    want = sorted(m2.engine_hits())
    assert got == want and want
    ends = [e for e, _p, _m in want]
    assert any(abs(e - 30020) <= 1 for e in ends)  # pre-EOS hit found
    assert any(abs(e - 31019) <= 1 for e in ends)  # post-EOS hit found
    assert not any(32005 < e < 32025 for e in ends)  # split = no match


def test_slot_overflow_segment_escape_parity():
    """A dense periodic hit cluster (every stride-8 start a full match)
    overflows the default candidate caps: the sticky cap growth must
    recover every hit — engine output identical to the host oracle."""
    rng = np.random.default_rng(99)
    n = 1 << 17
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    # period-8 pattern: planting one long periodic region makes EVERY
    # stride-8 start a full-pattern match, so >64 left-half seed hits
    # land in ONE (phase row, segment) bucket -> capg overflow
    pat = ("ACGTTGCA" * 2)[:14]
    period = np.asarray([b"ACGT".index(c.encode()) for c in "ACGTTGCA"],
                        np.uint8)
    region = np.tile(period, 82)  # 81 stride-8 match starts
    codes[1000 : 1000 + len(region)] = region
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    ps = build_pattern_set([pat], rev_comp=True)
    m = PrimerMatchModel(db, ps, k=1)
    m.use_host = False
    sc = m._halves_ctx()[1]
    sc.force_device = True
    got = sorted(m.engine_hits())

    m2 = PrimerMatchModel(db, ps, k=1)
    m2.use_host = False
    o2 = m2._halves_ctx()[1]
    o2.use_fused = False
    want = sorted(m2.engine_hits())
    assert got == want
    assert len(want) >= 80  # the planted cluster is all found


@pytest.mark.parametrize("indels", [True, False])
def test_gated_many_patterns_matches_host(indels):
    """A k=1 panel of 40 primers on both strands — 160 half seeds, past
    the 64-pattern envelope of the old in-kernel pipeline — through the
    fused gated pipeline: engine output identical to the host engine."""
    rng = np.random.default_rng(41)
    n = 1 << 16
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    text = "".join("ACGT"[c] for c in codes[:8000])
    pats = [text[i * 150 : i * 150 + 16 + i % 5] for i in range(40)]
    for i, p in enumerate(pats[:10]):  # 1-edit copies elsewhere
        mut = _mutate(rng, p, 1, indels)
        at = 20000 + 1500 * i
        codes[at : at + len(mut)] = [b"ACGT".index(c.encode()) for c in mut]
    ps = build_pattern_set(pats, rev_comp=True)
    host = PrimerMatchModel(db, ps, k=1, node=11, indels=indels)
    host.use_host = True
    want = list(host.engine_hits())
    gated = PrimerMatchModel(db, ps, k=1, node=11, indels=indels)
    gated.force_device = True
    _o, sc, *_rest = gated._halves_ctx()
    assert sc.tables.P > 64
    got = list(gated.engine_hits())
    assert got == want
    assert len(want) >= 50
