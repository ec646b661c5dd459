"""Engine-route announcements (VERDICT r3 item 8): every tier change —
host machine vs fused pipeline vs gated pipeline vs Sellers scans —
must be observable as a ``Route:`` strategy line (select.cc:182-275
announcement spirit) under SAT_ROUTE_VERBOSE=1 or -v, with a pinned
format."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.models.primer_match import PrimerMatchModel

PATS = ["ACGTACGTACGTA", "TTGGCCAATTGGC"]


def _routes(capfd):
    err = capfd.readouterr().err
    return [ln.split("Route: ", 1)[1] for ln in err.splitlines()
            if "Route: " in ln]


@pytest.fixture()
def small_db():
    rng = np.random.default_rng(5)
    n = 50000
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    return SeqDB(codes=codes, table=b"ACGT\n",
                 entry_starts=np.array([0]),
                 entry_lengths=np.array([n]), headers=["e"])


@pytest.fixture()
def route_env(monkeypatch):
    monkeypatch.setenv("SAT_ROUTE_VERBOSE", "1")


def test_gated_slots_route(small_db, route_env, capfd):
    ps = build_pattern_set(PATS, rev_comp=True)
    m = PrimerMatchModel(small_db, ps, k=1, indels=True)
    m.force_device = True
    list(m.engine_hits())
    routes = _routes(capfd)
    assert any(re.fullmatch(
        r"fused gated pipeline \(P=\d+, Lmax=\d+, k=\d+\)", r)
        for r in routes), routes


def test_host_tier_route(small_db, route_env, capfd):
    ps = build_pattern_set(PATS, rev_comp=True)
    m = PrimerMatchModel(small_db, ps, k=0)
    list(m.engine_hits())
    routes = _routes(capfd)
    assert any(r.startswith("native shift-and host machine")
               or r.startswith("fused microhit")
               or r.startswith("host ") for r in routes), routes


def test_myers_vs_sellers_route(small_db, route_env, capfd):
    """The k-edit scans announce which one runs: the block DP from
    ``scan``, the whole-array device scan from ``scan_pairs``, for short
    and long patterns alike."""
    from sequence_alignment_tools.ops.sellers import SellersScanner
    from sequence_alignment_tools.ops.tables import build_tables

    ps = build_pattern_set(PATS, rev_comp=True)
    t = build_tables(ps, small_db, wc=False, textn=False)
    sc = SellersScanner(t, k=1, indels=True)
    sc.force_device = True
    sc.use_host = False
    list(sc.scan(small_db.codes[:20000]))
    routes = _routes(capfd)
    assert any(r.startswith("XLA Sellers block DP") for r in routes), routes
    long_ps = build_pattern_set(["ACGT" * 10], rev_comp=False)
    t2 = build_tables(long_ps, small_db, wc=False, textn=False)
    sc2 = SellersScanner(t2, k=1, indels=True)
    sc2.force_device = True
    sc2.use_host = False
    sc2.scan_pairs(small_db.codes[:20000])
    routes2 = _routes(capfd)
    assert any(r.startswith("XLA Sellers whole-array scan")
               for r in routes2), routes2


def test_cli_v_prints_routes(tmp_path):
    """-v (progress reporter attached) also enables Route: lines."""
    fa = tmp_path / "x.fasta"
    rng = np.random.default_rng(9)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=4000))
    fa.write_text(">e demo\n" + "\n".join(
        seq[i : i + 70] for i in range(0, len(seq), 70)) + "\n")
    r = subprocess.run(
        [sys.executable, "-m",
         "sequence_alignment_tools.apps.primer_match",
         "-i", str(fa), "-p", PATS[0], "-r", "-c", "-v"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 0
    assert "Route: " in r.stderr, r.stderr[-2000:]
