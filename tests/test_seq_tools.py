"""Byte parity for the sequence-analysis tools: kmer_count, polyrun,
protein_mw."""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.kmer_count import (
    parse_args as kc_args, run as kc_run,
)
from sequence_alignment_tools.apps.polyrun import (
    parse_args as pr_args, run as pr_run,
)
from sequence_alignment_tools.apps.protein_mw import (
    parse_args as mw_args, run as mw_run,
)


@pytest.fixture(scope="module")
def seq_fasta(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("seqtools")
    rng = random.Random(11)
    seq = [rng.choice("ACGT") for _ in range(8000)]
    seq[500:530] = ["A"] * 30
    seq[1000:1025] = ["N"] * 25
    seq[2000:2022] = ["T"] * 22
    seq[3000:3040] = ["G"] * 40
    seq[3900:3925] = ["x"] * 25
    s = "".join(seq)
    path = d / "poly.fasta"
    with open(path, "w") as f:
        f.write(">p1 poly entry one\n")
        for i in range(0, 5000, 70):
            f.write(s[i : i + 70] + "\n")
        f.write(">p2 poly entry two\n")
        for i in range(5000, len(s), 70):
            f.write(s[i : i + 70] + "\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(path), "-n", "true"],
        check=True, capture_output=True,
    )
    return str(path)


KC_CONFIGS = [
    ["-k", "4", "-a"],
    ["-k", "3"],
    ["-k", "5", "-M", "10"],
    ["-k", "2", "-a", "-n"],
    ["-k", "1", "-a"],
    ["-k", "6", "-a", "-N"],
]


def _run_flaky(cmd, text=True):
    """The reference kmer_count aborts nondeterministically at exit
    (double-free in cleanup) which can truncate buffered output — retry
    until a clean exit."""
    for _ in range(10):
        r = subprocess.run(cmd, capture_output=True, text=text)
        if r.returncode == 0:
            return r.stdout
    raise AssertionError(f"oracle never exited cleanly: {cmd}")


@pytest.mark.parametrize("cfg", KC_CONFIGS, ids=lambda c: " ".join(c))
def test_kmer_count_parity(oracle, seq_fasta, cfg):
    kc = os.path.join(oracle, "kmer_count")
    if not os.access(kc, os.X_OK):
        pytest.skip("kmer_count oracle unavailable")
    args = ["-i", seq_fasta] + cfg
    ref = _run_flaky([kc] + args)
    buf = io.StringIO()
    kc_run(kc_args(args), buf)
    assert buf.getvalue() == ref


def test_kmer_count_binary(oracle, seq_fasta, tmp_path):
    kc = os.path.join(oracle, "kmer_count")
    if not os.access(kc, os.X_OK):
        pytest.skip("kmer_count oracle unavailable")
    args = ["-i", seq_fasta, "-k", "4", "-a", "-b"]
    ref = _run_flaky([kc] + args, text=False)
    out = tmp_path / "kc.bin"
    from sequence_alignment_tools.apps.kmer_count import main as kc_main

    kc_main(args + ["-o", str(out)])
    assert out.read_bytes() == ref


PR_CONFIGS = [
    ["-l", "20"],
    ["-l", "20", "-n"],
    ["-l", "20", "-N"],
    ["-l", "22", "-A", r"%f|%H|%s|%e|%S|%E|%t|%l\n"],
    ["-l", "40"],
]


@pytest.mark.parametrize("cfg", PR_CONFIGS, ids=lambda c: " ".join(c))
def test_polyrun_parity(oracle, seq_fasta, cfg):
    pr = os.path.join(oracle, "polyrun")
    if not os.access(pr, os.X_OK):
        pytest.skip("polyrun oracle unavailable")
    args = ["-i", seq_fasta] + cfg
    ref = _run_flaky([pr] + args)
    buf = io.StringIO()
    pr_run(pr_args(args), buf)
    assert buf.getvalue() == ref


def test_protein_mw_parity(oracle, seq_fasta, tmp_path):
    mass = tmp_path / "mass.txt"
    mass.write_text(
        "A 71.037113848\nC 103.009185648\nG 57.021463768\nT 101.047678568\n"
    )
    idx = tmp_path / "idx.txt"
    idx.write_text("1\n2\n1\n")
    args = ["-i", seq_fasta, "-I", str(idx), "-m", str(mass)]
    ref = _run_flaky([os.path.join(oracle, "protein_mw")] + args)
    buf = io.StringIO()
    mw_run(mw_args(args), buf)
    assert buf.getvalue() == ref
