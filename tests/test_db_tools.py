"""Parity/behavior tests for nrdb, extract_seq, and tandem_match."""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.extract_seq import (
    parse_args as ex_args, run as ex_run,
)
from sequence_alignment_tools.apps.nrdb import (
    parse_args as nr_args, run as nr_run,
)
from sequence_alignment_tools.apps.tandem_match import (
    parse_args as tm_args, run as tm_run,
)


@pytest.fixture(scope="module")
def nr_fasta(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("nrdb")
    rng = random.Random(19)
    base = "".join(rng.choice("ACGT") for _ in range(300))
    e2 = "".join(rng.choice("ACGT") for _ in range(250))
    entries = [
        ("a1 first entry", base),
        ("a2 duplicate of first", base),
        ("a3 distinct", e2),
        ("a4 contained in a3", e2[50:200]),
        ("a5 short", "ACG"),
        ("a6 another dup of first", base),
        ("a7 prefix-sharing but distinct", base[:100] + "T" + base[101:]),
    ]
    path = d / "nr.fasta"
    with open(path, "w") as f:
        for h, s in entries:
            f.write(f">{h}\n")
            for i in range(0, len(s), 55):
                f.write(s[i : i + 55] + "\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(path), "-n", "true"],
        check=True, capture_output=True,
    )
    return str(path)


NR_CONFIGS = [[], ["-C"], ["-b"], ["-C", "-b"], ["-x", "10"],
              ["-S", "-x", "5"]]


@pytest.mark.parametrize("cfg", NR_CONFIGS, ids=lambda c: " ".join(c) or "d")
def test_nrdb_parity(oracle, nr_fasta, cfg):
    nr = os.path.join(oracle, "nrdb")
    if not os.access(nr, os.X_OK):
        pytest.skip("nrdb oracle unavailable")
    args = ["-i", nr_fasta] + cfg
    ref = subprocess.run([nr] + args, capture_output=True, text=True,
                         check=True).stdout
    buf = io.StringIO()
    nr_run(nr_args(args), buf)
    assert buf.getvalue() == ref


def test_extract_seq_parity(oracle, nr_fasta, tmp_path):
    ex = os.path.join(oracle, "extract_seq")
    if not os.access(ex, os.X_OK):
        pytest.skip("extract_seq oracle unavailable")
    pos = tmp_path / "pos.txt"
    pos.write_text(
        "0 10 20\n2 5 30\n-1 400 15\n1 0 10\n"
        "0 290 20\n5 0 5\n99 0 5\n0 0 0\n2 10 8\n"
    )
    args = ["-i", nr_fasta, "-A", str(pos)]
    ref = subprocess.run([ex] + args, capture_output=True, text=True,
                         check=True).stdout
    buf = io.StringIO()
    ex_run(ex_args(args), buf)
    assert buf.getvalue() == ref


@pytest.fixture(scope="module")
def tandem_fasta(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("tandem")
    rng = random.Random(5)
    seq = [rng.choice("ACGT") for _ in range(5000)]
    seq[500:530] = list("CAG" * 10)
    seq[1000:1012] = list("TTAG" * 3)
    seq[2000:2015] = list("CAT" * 5)
    s = "".join(seq)
    path = d / "tr.fasta"
    with open(path, "w") as f:
        f.write(">t1 tandem entry\n")
        for i in range(0, len(s), 70):
            f.write(s[i : i + 70] + "\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(path), "-n", "true"],
        check=True, capture_output=True,
    )
    return str(path)


def test_tandem_arrays(tandem_fasta):
    """Reference tandem_match is bit-rotted (doesn't compile): behavioral
    checks against the documented semantics instead."""
    buf = io.StringIO()
    tm_run(tm_args(["-i", tandem_fasta, "-p", "CAG TTAG", "-c", "3",
                    "-l", "9"]), buf)
    outp = buf.getvalue()
    assert "CAG" * 10 + " 500 530" in outp
    assert "TTAG" * 3 + " 1000 1012" in outp
    # no partial arrays below the copy-count gate
    assert outp.count(">t1") == 2


def test_tandem_revcomp(tandem_fasta):
    buf = io.StringIO()
    tm_run(tm_args(["-i", tandem_fasta, "-p", "ATG", "-r", "-c", "4"]), buf)
    outp = buf.getvalue()
    assert "CAT" * 5 + " 2000 2015" in outp
    assert "REVCOMP" in outp


def test_tandem_min_length_gate(tandem_fasta):
    buf = io.StringIO()
    tm_run(tm_args(["-i", tandem_fasta, "-p", "CAG", "-c", "3",
                    "-l", "31"]), buf)
    assert buf.getvalue() == ""  # the 30-char array fails the -l 31 gate
