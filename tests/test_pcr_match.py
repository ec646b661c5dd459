"""pcr_match pair-join byte parity vs the reference binary."""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.pcr_match import parse_args, run

RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _rc(s):
    return "".join(RC[c] for c in reversed(s))


PAIRS = [
    ("ACGTTGCATGCAT", "TTGGCCAATTGGA"),
    ("GGATCCGATCGATTA", "CCATGGTACCATG"),
    ("TTTACACGTGTGAAC", "GATTACAGATTACA"),
]


@pytest.fixture(scope="module")
def pcr_fasta(tmp_path_factory):
    """Two entries with planted amplicons: exact, 1-sub, reverse-strand,
    overlapping-window and cross-entry (negative) cases."""
    rng = random.Random(99)
    seq = [rng.choice("ACGT") for _ in range(30000)]

    def plant(at, f, r, amplen, sub=False):
        ins = list(f) + [rng.choice("ACGT")
                         for _ in range(amplen - len(f) - len(r))] + \
            list(_rc(r))
        if sub:
            i = len(f) // 2
            ins[i] = "ACGT"[("ACGT".index(ins[i]) + 1) % 4]
        seq[at : at + amplen] = ins

    f1, r1 = PAIRS[0]
    f2, r2 = PAIRS[1]
    f3, r3 = PAIRS[2]
    plant(500, f1, r1, 200)
    plant(1200, f1, r1, 350, sub=True)
    plant(2500, f2, r2, 120)
    # reverse strand: plant rc of the amplicon (rc(r) ... rc(f) reading fwd)
    amp = list(f3) + [rng.choice("ACGT") for _ in range(150 - len(f3) - len(r3))] + list(_rc(r3))
    rc_amp = list(_rc("".join(amp)))
    seq[4000 : 4000 + 150] = rc_amp
    # a very long amplicon (tests -M boundary at 2000)
    plant(6000, f1, r1, 1995)
    plant(9000, f2, r2, 2100)  # beyond default maxdist
    # overlapping primers (tiny amplicon, tests -m)
    plant(12000, f3, r3, len(f3) + len(r3) + 3)
    # second entry with a plant crossing nothing (entry boundary negative test
    # handled by is_subseq)
    plant(20500, f2, r2, 400)

    path = tmp_path_factory.mktemp("pcr") / "pcr.fasta"
    s = "".join(seq)
    with open(path, "w") as f:
        f.write(">chrA first test entry\n")
        for i in range(0, 20000, 70):
            f.write(s[i : i + 70] + "\n")
        f.write(">chrB second test entry\n")
        for i in range(20000, len(s), 70):
            f.write(s[i : i + 70] + "\n")
    return str(path)


@pytest.fixture(scope="module")
def pair_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("pcr") / "pairs.txt"
    with open(path, "w") as f:
        for a, b in PAIRS:
            f.write(f"{a} {b}\n")
    return str(path)


@pytest.fixture(scope="module")
def sts_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("pcr") / "pairs.sts"
    rows = [
        ("STS1", PAIRS[0][0], PAIRS[0][1], "180-220", "ACC1", "1", "ALT1", "Homo sapiens"),
        ("STS2", PAIRS[1][0], PAIRS[1][1], "120", "ACC2", "2", "", ""),
        ("STS3", PAIRS[2][0], PAIRS[2][1], "140-160", "", "", "", ""),
    ]
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(r) + "\n")
    return str(path)


CONFIGS = [
    ["-r"],
    ["-r", "-a"],
    [],  # no -r: reverse primer as given
    ["-r", "-k", "1"],
    ["-r", "-K", "1"],
    ["-r", "-M", "500"],
    ["-r", "-m", "100", "-M", "1000"],
    ["-r", "-b"],
    ["-r", "-a", "-k", "1"],
    ["-r", "-A", r"%i|%>s|%>e|%<s|%<e|%>S|%>E|%<S|%<E|%l|%>l|%<l|%>d|%<d|%>r|%<r|%r|%R|%>p|%<p|%>q|%<q|%N|%h|%H|%f|%%\n%@\n%*\n"],
    ["-r", "-k", "1", "-5", "3"],
    ["-r", "-3", "8"],
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c) or "plain")
def test_pair_parity(oracle, pcr_fasta, pair_file, cfg):
    args = ["-i", pcr_fasta, "-P", pair_file] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "pcr_match")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(args), buf)
    assert buf.getvalue() == ref


STS_CONFIGS = [
    [],
    ["-d", "30"],
    ["-d", "0"],
    ["-a"],
    ["-A", r"%I|%L|%>L|%<L|%D|%a|%O|%&|%X|%i|%>s|%<e|%l\n%0\n"],
]


@pytest.mark.parametrize("cfg", STS_CONFIGS, ids=lambda c: " ".join(c) or "sts")
def test_sts_parity(oracle, pcr_fasta, sts_file, cfg):
    args = ["-i", pcr_fasta, "-S", sts_file] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "pcr_match")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(args), buf)
    assert buf.getvalue() == ref


def test_fasta_pairs_parity(oracle, pcr_fasta, tmp_path):
    patf = tmp_path / "pairs.fasta"
    with open(patf, "w") as f:
        for i, (a, b) in enumerate(PAIRS):
            f.write(f">fwd{i} forward primer {i}\n{a}\n")
            f.write(f">rev{i} reverse primer {i}\n{b}\n")
    args = ["-i", pcr_fasta, "-F", str(patf), "-r",
            "-A", r"%i %>P %<P %>s %<e\n"]
    ref = subprocess.run(
        [os.path.join(oracle, "pcr_match")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(args), buf)
    assert buf.getvalue() == ref
