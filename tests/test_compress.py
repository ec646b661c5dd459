"""Byte-parity of compress_seq artifacts vs the reference binary."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from sequence_alignment_tools.io.compress import compress, load_db, pack_sqz, unpack_sqz
from sequence_alignment_tools.io.database import SeqDB


def _run_ref_compress(oracle, fasta, *args):
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", fasta, *args],
        check=True, capture_output=True,
    )


@pytest.mark.parametrize("exts", [[".hdr", ".idb", ".tbl", ".sqn", ".tbz", ".sqz"]])
def test_artifact_byte_parity(oracle, syn_fasta, tmp_path, exts):
    ref_fa = str(tmp_path / "ref.fasta")
    shutil.copy(syn_fasta, ref_fa)
    _run_ref_compress(oracle, ref_fa, "-n", "true", "-z", "true")

    mine_fa = str(tmp_path / "mine.fasta")
    shutil.copy(syn_fasta, mine_fa)
    compress(mine_fa, normalize=True, compress_bits=True)

    for ext in exts:
        ref_bytes = open(ref_fa + ext, "rb").read()
        my_bytes = open(mine_fa + ext, "rb").read()
        assert my_bytes == ref_bytes, f"{ext} differs: {len(my_bytes)} vs {len(ref_bytes)} bytes"

    # .seq removed by cleanup on both sides
    assert not os.path.exists(mine_fa + ".seq")


def test_seq_artifact_parity(oracle, syn_fasta, tmp_path):
    ref_fa = str(tmp_path / "r2.fasta")
    shutil.copy(syn_fasta, ref_fa)
    _run_ref_compress(oracle, ref_fa)
    mine_fa = str(tmp_path / "m2.fasta")
    shutil.copy(syn_fasta, mine_fa)
    compress(mine_fa)
    assert open(mine_fa + ".seq", "rb").read() == open(ref_fa + ".seq", "rb").read()
    assert open(mine_fa + ".idb", "rb").read() == open(ref_fa + ".idb", "rb").read()


def test_sqz_roundtrip():
    rng = np.random.default_rng(0)
    for alpha in (2, 5, 15, 24):
        codes = rng.integers(0, alpha, size=1001).astype(np.uint8)
        data = pack_sqz(codes, alpha)
        out = unpack_sqz(data, alpha, len(codes))
        np.testing.assert_array_equal(codes, out)


def test_load_db_roundtrip(syn_fasta, tmp_path):
    import shutil as sh

    fa = str(tmp_path / "db.fasta")
    sh.copy(syn_fasta, fa)
    raw_db = SeqDB.from_fasta(fa)
    compress(fa, normalize=True)
    db = load_db(fa)
    np.testing.assert_array_equal(db.codes, raw_db.codes)
    assert db.table == raw_db.table
    np.testing.assert_array_equal(db.entry_starts, raw_db.entry_starts)
    assert db.headers == raw_db.headers


def test_coordinates(syn_fasta):
    db = SeqDB.from_fasta(syn_fasta)
    # EOS at 0, entry 1 starts at flat 1
    assert db.entry_starts[0] == 1
    assert db.codes[0] == db.eos_code
    L1 = int(db.entry_lengths[0])
    assert db.codes[1 + L1] == db.eos_code
    # end position after a char at entry offset o is entry_start + o + 1
    e = int(db.entry_starts[0]) + 5 + 1
    assert db.get_seq_pos(e) == 6
    assert db.get_header_data(e).startswith("ent1")


def test_incremental_rebuild(syn_fasta, tmp_path):
    import shutil as sh

    fa = str(tmp_path / "inc.fasta")
    sh.copy(syn_fasta, fa)
    assert compress(fa, normalize=True) is True
    assert compress(fa, normalize=True) is False  # up to date
    assert compress(fa, normalize=True, check_only=True) is False
    os.utime(fa)  # touch source -> stale
    assert compress(fa, normalize=True, check_only=True) is True


def test_tableonly_addrc_parity(oracle, tmp_path):
    """-T true -R true: the reference applies the addrc revcomp closure
    to the TABLEONLY census too (compress_seq.cc:566-569) — a corpus
    with 'R' but no 'Y' must gain Y in the .tbl.  (Round-5 review fix:
    the -T branch previously skipped add_revcomp entirely.)"""
    import random

    rng = random.Random(9)
    seq = "".join(rng.choice("ACGR") for _ in range(3000))
    src = str(tmp_path / "rc.fasta")
    with open(src, "w") as f:
        f.write(">rc asymmetric alphabet\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i : i + 60] + "\n")
    ref_fa = str(tmp_path / "rcr.fasta")
    shutil.copy(src, ref_fa)
    _run_ref_compress(oracle, ref_fa, "-T", "true", "-R", "true")
    mine_fa = str(tmp_path / "rcm.fasta")
    shutil.copy(src, mine_fa)
    from sequence_alignment_tools.apps.compress_seq import main

    assert main(["-i", mine_fa, "-T", "true", "-R", "true"]) == 0
    want = open(ref_fa + ".tbl", "rb").read()
    assert open(mine_fa + ".tbl", "rb").read() == want
    assert b"Y" in want  # the closure actually added a char


def test_tableonly_parity(oracle, syn_fasta, tmp_path):
    """-T true writes ONLY the .tbl (dna-optimized census order), byte
    identical to the reference's (compress_seq.cc:213-218,365,690-722),
    and the guard flag round-trips (-G true leaves no stale .grd)."""
    ref_fa = str(tmp_path / "r3.fasta")
    shutil.copy(syn_fasta, ref_fa)
    _run_ref_compress(oracle, ref_fa, "-T", "true", "-G", "true")
    mine_fa = str(tmp_path / "m3.fasta")
    shutil.copy(syn_fasta, mine_fa)
    from sequence_alignment_tools.apps.compress_seq import main

    assert main(["-i", mine_fa, "-T", "true", "-G", "true"]) == 0
    assert open(mine_fa + ".tbl", "rb").read() == \
        open(ref_fa + ".tbl", "rb").read()
    for ext in (".seq", ".hdr", ".idb", ".idx", ".sqn", ".grd"):
        assert not os.path.exists(mine_fa + ext), ext
    # table-only staleness: fresh .tbl -> no rebuild; touched fasta -> yes
    assert not compress(mine_fa, tableonly=True, check_only=True)
    t2 = os.path.getmtime(mine_fa + ".tbl") + 2
    os.utime(mine_fa, (t2, t2))
    assert compress(mine_fa, tableonly=True, check_only=True)
