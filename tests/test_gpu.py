"""Device routes compiled for the GPU, against the host machines.

Skipped everywhere but on the card.  There, run them with

    SAT_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu.py

(``chip_smoke.py`` does, as one of its phases).  Each test takes the
route a scanner picks by itself on the GPU — no forcing — and compares
its hit set exactly with the native shift-and / Sellers row machines,
which are fuzz-pinned to the reference elsewhere in this suite.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")
N = 8 << 20  # past the fused route's small-input cutoff


def _dna_db(n=N, seed=0):
    from sequence_alignment_tools.io.database import SeqDB

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    codes[rng.integers(0, n, size=64)] = 4  # entry separators
    pats = [ln.strip() for ln in open(PAT) if ln.strip()]
    for i, p in enumerate(pats * 8):
        at = 5000 + i * (n // 90)
        codes[at : at + len(p)] = [b"ACGT".index(c.encode()) for c in p]
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["g"])
    return db, pats


def _host(tables, k, poison, codes):
    from sequence_alignment_tools.ops.host_scan import HostShiftAnd

    host = HostShiftAnd(tables, k, poison)
    assert host.available()
    return sorted(host.scan(codes))


@pytest.mark.parametrize("k", [0, 1])
def test_fused_scan_matches_host(gpu, k):
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.ops.tables import build_tables

    db, pats = _dna_db()
    t = build_tables(build_pattern_set(pats, rev_comp=True), db,
                     wc=False, textn=False)
    sc = ConvScanner(t, k=k, poison_eos=k > 0)
    sc.use_host = False
    assert sc.use_fused
    got = sorted(sc.scan(db.codes))
    assert got == _host(t, k, k > 0, db.codes) and len(got) >= 80


def test_gated_pipeline_matches_host_engine(gpu):
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    db, pats = _dna_db()
    ps = build_pattern_set(pats, rev_comp=True)
    dev = PrimerMatchModel(db, ps, k=1, mesh=None)
    dev.use_host = False
    _o, sc, *_rest = dev._halves_ctx()
    assert sc.gated_available(len(db.codes))
    got = list(dev.engine_hits())
    host = PrimerMatchModel(db, ps, k=1, mesh=None)
    host.use_host = True
    assert got == list(host.engine_hits()) and got


def test_sellers_scan_matches_host(gpu):
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.ops.sellers import SellersScanner
    from sequence_alignment_tools.ops.tables import build_tables

    db, pats = _dna_db(n=N // 2)
    t = build_tables(build_pattern_set(pats, rev_comp=True), db,
                     wc=False, textn=False)
    sc = SellersScanner(t, k=2, indels=True)
    assert sc.device_available(len(db.codes))
    ends, pids = sc.scan_pairs(db.codes)
    host = SellersScanner(t, k=2, indels=True)
    assert host._host_eligible(len(db.codes))
    he, hp = host.host_pairs(db.codes)
    got = sorted(zip(ends.tolist(), pids.tolist()))
    assert got == sorted(zip(he.tolist(), hp.tolist())) and got


@pytest.mark.parametrize("alphabet", ["iupac", "peptide"])
def test_bitplane_modes_match_host(gpu, tmp_path, alphabet):
    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.ops.tables import build_tables

    rng = np.random.default_rng(5)
    n = 4 << 20
    if alphabet == "iupac":
        table = b"ACGTRYSWKMBDHVN"
        base = rng.integers(0, 4, size=n)
        amb = rng.random(n) < 0.02
        base[amb] = rng.integers(4, 15, size=int(amb.sum()))
        L, wc = 12, True
    else:
        table = b"ACDEFGHIKLMNPQRSTVWY"
        base = rng.integers(0, 20, size=n)
        L, wc = 9, False
    seq = np.frombuffer(table, np.uint8)[base].tobytes().decode()
    path = tmp_path / "db.fasta"
    path.write_text(">w\n" + seq + "\n")
    db = SeqDB.from_fasta(str(path))
    pats = [seq[i : i + L] for i in range(1000, n - 100, n // 12)]
    t = build_tables(build_pattern_set(pats, rev_comp=wc), db, wc=wc,
                     textn=False)
    sc = ConvScanner(t, k=0)
    sc.use_host = False
    got = sorted(sc.scan(np.asarray(db.codes)))
    assert sc._bitplane_cc not in (False, None)
    assert got == _host(t, 0, False, np.asarray(db.codes)) and got


def test_sharded_scan_matches_single(gpu):
    import jax

    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.ops.tables import build_tables
    from sequence_alignment_tools.parallel.shard import make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs two or more GPUs")
    db, pats = _dna_db()
    t = build_tables(build_pattern_set(pats, rev_comp=True), db,
                     wc=False, textn=False)
    one = ConvScanner(t, k=0)
    one.use_host = False
    want = sorted(one.scan(db.codes))
    many = ConvScanner(t, k=0)
    many.use_host = False
    many.mesh = make_mesh()
    assert sorted(many.scan(db.codes)) == want and want


def test_tail_workers_stay_off_the_card(gpu):
    """The k-edit serving stream's host-tail worker processes rebuild the
    model on the CPU platform: with this process holding the card, a
    worker that opened it would fail for want of memory.  Per-run output
    equals the plain engine's."""
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    db, pats = _dna_db(n=N // 4)
    ps = build_pattern_set(pats, rev_comp=True)
    m = PrimerMatchModel(db, ps, k=2, mesh=None)
    m.use_host = False
    assert m.engine == "filter"
    want = sorted(m.engine_hits())
    outs = [sorted(o) for o in m.engine_hits_stream(3)]
    assert m._tailproc_c, "tail worker processes did not start"
    assert outs == [want] * 3 and want
