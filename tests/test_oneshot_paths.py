"""One-shot latency behaviors (VERDICT r3 item 4): artifact
self-persistence, device probing that surfaces a failed backend, and
the device-count cache that lets a host-served CLI run skip backend
initialization."""

import os

import numpy as np
import pytest

from sequence_alignment_tools.io.compress import load_db


@pytest.fixture()
def small_fasta(tmp_path):
    rng = np.random.default_rng(17)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=5000))
    fa = tmp_path / "db.fasta"
    fa.write_text(">e1 demo\n" + "\n".join(
        seq[i : i + 70] for i in range(0, len(seq), 70)) + "\n")
    return str(fa)


def test_auto_artifacts_persist_and_match(small_fasta, monkeypatch):
    raw_db = load_db(small_fasta)
    assert not os.path.exists(small_fasta + ".seq")
    monkeypatch.setenv("SAT_AUTO_ARTIFACTS", "1")
    db1 = load_db(small_fasta)
    # reference-format artifacts persisted on first touch
    for ext in (".seq", ".hdr", ".idb"):
        assert os.path.exists(small_fasta + ext), ext
    assert db1.source_kind == "seq"
    # artifact-loaded content identical to the raw parse
    assert np.array_equal(np.asarray(db1.codes), np.asarray(raw_db.codes))
    assert db1.table == raw_db.table
    assert list(db1.headers) == list(raw_db.headers)
    # second load comes from the artifacts without the env var
    monkeypatch.delenv("SAT_AUTO_ARTIFACTS")
    db2 = load_db(small_fasta)
    assert db2.source_kind == "seq"
    assert np.array_equal(np.asarray(db2.codes), np.asarray(raw_db.codes))


def test_probe_devices_never_raises(monkeypatch, tmp_path):
    """A backend that fails to start is an error, never a silent
    single-device fallback: on a GPU host that would hide the card."""
    from sequence_alignment_tools.parallel import shard

    class Boom:
        def __call__(self):
            raise RuntimeError("backend unavailable")

    monkeypatch.setattr(shard, "_devcount_cache_path",
                        lambda: str(tmp_path / "devcount0"))
    monkeypatch.setenv("SAT_MESH", "auto")
    monkeypatch.setattr(shard.jax, "devices", Boom())
    with pytest.raises(RuntimeError, match="backend unavailable"):
        shard.auto_mesh()


def test_auto_mesh_devcount_cache(monkeypatch, tmp_path):
    from sequence_alignment_tools.parallel import shard

    path = str(tmp_path / "devcount")
    monkeypatch.setattr(shard, "_devcount_cache_path", lambda: path)
    monkeypatch.setenv("SAT_MESH", "auto")
    # cached single-device count: returns None WITHOUT touching the
    # backend (jax.devices raising proves it was never called on the
    # synchronous path; the stale-refresh thread is suppressed by a
    # fresh mtime)
    with open(path, "w") as f:
        f.write("1")

    def boom():
        raise AssertionError("backend init on the cached-1 path")

    monkeypatch.setattr(shard.jax, "devices", boom)
    assert shard.auto_mesh() is None
    # explicit off-switch still wins
    monkeypatch.setenv("SAT_MESH", "0")
    assert shard.auto_mesh() is None


def test_auto_mesh_probe_failure_degrades(monkeypatch, tmp_path):
    from sequence_alignment_tools.parallel import shard

    path = str(tmp_path / "devcount2")
    monkeypatch.setattr(shard, "_devcount_cache_path", lambda: path)
    monkeypatch.setenv("SAT_MESH", "auto")

    def held():
        raise RuntimeError("no device")

    monkeypatch.setattr(shard.jax, "devices", held)
    # no cache + unreachable backend -> the error surfaces, and no
    # device count is cached for later runs to trust
    with pytest.raises(RuntimeError, match="no device"):
        shard.auto_mesh()
    assert not os.path.exists(path)
    monkeypatch.setenv("SAT_MESH", "4")
    with pytest.raises(RuntimeError, match="no device"):
        shard.auto_mesh()
