"""The site-less ``sat`` launcher: cold-start boot path (round 5).

The launcher boots ``python -S``, puts site-packages + the repo on
sys.path itself, and the package's ``_LazyJaxBoot`` hook defers the jax
import (and its cache/platform config) to the first device route.
Pinned here:

- byte parity with the sited ``python -m`` boot on host-routed one-shot
  runs, with jax PROVABLY never imported (``SAT_BOOT_DEBUG``);
- a forced device route under the launcher still works (the lazy boot
  hook imports jax mid-run and the scan output stays identical);
- the jax-free mesh peek (``parallel.devcache.peek_no_mesh``) agrees
  with ``auto_mesh``'s cached-single-device semantics.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAT = os.path.join(HERE, "sat")


@pytest.fixture()
def fasta(tmp_path):
    rng = np.random.default_rng(99)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=200_000))
    # plant a hit for each pattern
    seq = seq[:500] + "ACGTACGTACGTACGTACGT" + seq[500:]
    fa = tmp_path / "db.fasta"
    fa.write_text(">e1 launcher test\n" + "\n".join(
        seq[i: i + 70] for i in range(0, len(seq), 70)) + "\n")
    pf = tmp_path / "pats.txt"
    pf.write_text("ACGTACGTACGTACGTACGT\nTTTTACGTTT\n")
    return str(fa), str(pf)


def _run(cmd, env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(env_extra)
    return subprocess.run(cmd, capture_output=True, timeout=600,
                          env=env, cwd=HERE)


def test_launcher_host_route_parity_and_jax_free(fasta):
    fa, pf = fasta
    args = ["primer_match", "-i", fa, "-P", pf, "-r", "-c", "-k", "1"]
    env = {"SAT_BOOT_DEBUG": "1", "SAT_MESH": "0"}
    r1 = _run([sys.executable, "-S", SAT] + args, env)
    assert r1.returncode == 0, r1.stderr[-800:]
    assert b"sat-boot: jax_imported=False" in r1.stderr, (
        "host-routed one-shot run imported jax under the launcher:\n"
        + r1.stderr.decode()[-800:])
    r2 = _run([sys.executable, "-m", "sequence_alignment_tools"]
              + args, {"SAT_MESH": "0"})
    assert r2.returncode == 0, r2.stderr[-800:]
    assert r1.stdout == r2.stdout


def test_launcher_device_route_lazy_jax_boot(fasta):
    """Force a 2-device CPU mesh under the launcher: the model's mesh
    path imports jax mid-run through ``_LazyJaxBoot`` (cache/platform
    config) and output must match the sited boot byte-for-byte."""
    fa, pf = fasta
    args = ["primer_match", "-i", fa, "-P", pf, "-r", "-c"]
    env = {
        "SAT_BOOT_DEBUG": "1",
        "SAT_MESH": "2",
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
    }
    r1 = _run([sys.executable, "-S", SAT] + args, env)
    assert r1.returncode == 0, r1.stderr[-1200:]
    assert b"sat-boot: jax_imported=True" in r1.stderr
    r2 = _run([sys.executable, "-m", "sequence_alignment_tools"]
              + args, {k: v for k, v in env.items()
                       if k != "SAT_BOOT_DEBUG"})
    assert r2.returncode == 0, r2.stderr[-1200:]
    assert r1.stdout == r2.stdout


def test_peek_no_mesh_semantics(monkeypatch, tmp_path):
    from sequence_alignment_tools.parallel import devcache

    path = str(tmp_path / "devcount")
    monkeypatch.setattr(devcache, "devcount_cache_path", lambda: path)
    monkeypatch.setenv("SAT_MESH", "auto")
    # no cache: must fall through to the real auto_mesh (False)
    assert not devcache.peek_no_mesh()
    with open(path, "w") as f:
        f.write("1")
    assert devcache.peek_no_mesh()  # fresh cached 1 -> definitely no mesh
    os.utime(path, (1, 1))  # stale: auto_mesh must arm its refresh
    assert not devcache.peek_no_mesh()
    with open(path, "w") as f:
        f.write("8")
    assert not devcache.peek_no_mesh()
    monkeypatch.setenv("SAT_MESH", "off")
    assert devcache.peek_no_mesh()
    monkeypatch.setenv("SAT_MESH", "4")
    assert not devcache.peek_no_mesh()
