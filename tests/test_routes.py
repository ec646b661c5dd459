"""Backend route choice and compile-cache placement.

On the GPU the scanners take the device routes (the fused microhit
pipeline, the whole-array Sellers scan); on the CPU they take the host
machines and the XLA block scans, and nothing reaches the fused route
unless a caller forces it.  The persistent compile cache honours
``JAX_COMPILATION_CACHE_DIR`` and otherwise lives at one fixed path in
the checkout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.sellers import SellersScanner
from sequence_alignment_tools.ops.tables import build_tables
from sequence_alignment_tools.utils import lazyjax

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables(n, pats):
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    return db, build_tables(build_pattern_set(pats, rev_comp=True), db,
                            wc=False, textn=False)


@pytest.mark.parametrize("gpu", [True, False])
def test_backend_route_choice(monkeypatch, capfd, gpu):
    monkeypatch.setattr(lazyjax, "on_gpu", lambda: gpu)
    monkeypatch.setenv("SAT_ROUTE_VERBOSE", "1")
    db, t = _tables(1 << 20, ["ACGTTGCAACGTAC", "TTGACCAGTAGCAT"])
    sc = ConvScanner(t, k=0)
    assert sc.use_fused is gpu
    assert sc.force_device is False
    assert SellersScanner(t, k=1).device_available(1 << 22) is gpu
    # patterns past the fused filter take the block scan on any backend
    _db, t_long = _tables(1 << 12, ["ACGT" * 40])
    assert ConvScanner(t_long, k=0).use_fused is False
    sc.use_host = False
    list(sc.scan(db.codes))
    routes = [ln for ln in capfd.readouterr().err.splitlines()
              if "Route: " in ln]
    fused = any("fused microhit scan pipeline" in r for r in routes)
    block = any("XLA block-scan fallback" in r for r in routes)
    assert (fused, block) == (gpu, not gpu), routes


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    import sequence_alignment_tools as sat

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "xla")
    r = subprocess.run(
        [sys.executable, "-c",
         "import sequence_alignment_tools, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, env=env, cwd=HERE, timeout=300)
    assert r.returncode == 0, r.stderr[-800:]
    want = str(tmp_path / "xla") if env_set else sat.CACHE_DIR
    assert r.stdout.strip() == want
    assert sat.CACHE_DIR == os.path.join(HERE, ".jax_cache")
