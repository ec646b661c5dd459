"""End-to-end byte parity of primer_match output vs the reference binary.

This is this framework's version of the reference's testscript.sh identity
matrix (testscript.sh:146-422): the same query under many configurations must
produce byte-identical output.
"""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.primer_match import parse_args, run

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")


@pytest.fixture(scope="module")
def planted_fasta(tmp_path_factory):
    """Corpus with exact/1-sub/1-del/1-ins/2-sub plants of every pattern."""
    rng = random.Random(13)
    pats = [l.strip() for l in open(PAT) if l.strip()]
    seq = [rng.choice("ACGT") for _ in range(60000)]
    pos = 500
    for p in pats:
        for mode in ("exact", "sub1", "del1", "ins1", "sub2"):
            s = list(p)
            if mode == "sub1":
                i = len(s) // 2
                s[i] = "ACGT"[("ACGT".index(s[i]) + 1) % 4]
            elif mode == "del1":
                del s[len(s) // 3]
            elif mode == "ins1":
                s.insert(2 * len(s) // 3, "T")
            elif mode == "sub2":
                for i in (1, len(s) - 2):
                    s[i] = "ACGT"[("ACGT".index(s[i]) + 2) % 4]
            seq[pos : pos + len(s)] = s
            pos += len(s) + 97
    path = tmp_path_factory.mktemp("pm") / "planted.fasta"
    with open(path, "w") as f:
        f.write(">e1 first entry\n")
        for i in range(0, 40000, 70):
            f.write("".join(seq[i : i + 70]) + "\n")
        f.write(">e2 second entry\n")
        for i in range(40000, len(seq), 70):
            f.write("".join(seq[i : i + 70]) + "\n")
    return str(path)


CONFIGS = [
    [],
    ["-r"],
    ["-c"],
    ["-r", "-c"],
    ["-r", "-c", "-a"],
    ["-k", "1"],
    ["-k", "2"],
    ["-K", "1"],
    ["-K", "2"],
    ["-k", "1", "-r"],
    ["-k", "2", "-r", "-c"],
    ["-k", "1", "-r", "-A", r"%h\t%H\t%f\t%s\t%e\t%5\t%3\t%S\t%E\t%i\t%d\t%p\t%q\t%Q\t%t\t%T\t%A\t%r\t%R\t%%\n"],
    ["-k", "2", "-C", r"%i\t%p\t%q\t%r\t%R\t%c\t%C\t%+\t%%\n"],
    ["-k", "1", "-s", "4"],
    ["-k", "1", "-e", "4"],
    ["-k", "1", "-r", "-3", "8"],
    ["-k", "2", "-c", "-M", "2"],
    # %m/%G melting-temperature escapes with every source selector and the
    # unrecognized-selector fall-through (primer_match.cc:528-567)
    ["-k", "1", "-r", "-A",
     r"%i %s %e %r %m %G %mp %mq %mt %mU %Gp %GU %mX\n"],
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c) or "k0")
def test_output_parity(oracle, planted_fasta, cfg):
    ref = subprocess.run(
        [os.path.join(oracle, "primer_match"), "-i", planted_fasta, "-P", PAT]
        + cfg,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(["-i", planted_fasta, "-P", PAT] + cfg), buf)
    assert buf.getvalue() == ref


def test_fasta_pattern_input(oracle, planted_fasta):
    patf = "/root/reference/db/pat.fasta"
    cfg = ["-i", planted_fasta, "-F", patf, "-k", "1",
           "-A", r">%h %P\n %T %s %e %d\n %A\n %Q %i%R\n"]
    ref = subprocess.run(
        [os.path.join(oracle, "primer_match")] + cfg,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(cfg), buf)
    assert buf.getvalue() == ref


def test_wildcards(oracle, planted_fasta):
    patwc = "/root/reference/db/patwc.txt"
    if not os.path.exists(patwc):
        pytest.skip("no wildcard patterns")
    for flags in (["-w"], ["-W"], ["-w", "-k", "1"]):
        cfg = ["-i", planted_fasta, "-P", patwc] + flags
        ref = subprocess.run(
            [os.path.join(oracle, "primer_match")] + cfg,
            capture_output=True, text=True, check=True,
        ).stdout
        buf = io.StringIO()
        run(parse_args(cfg), buf)
        assert buf.getvalue() == ref, f"flags={flags}"


N_MATRIX = [(N, kk) for N in range(1, 15)
            for kk in (["-k", "0"], ["-k", "1"], ["-k", "1", "-s", "6"],
                       ["-k", "1", "-e", "6"])]


@pytest.mark.parametrize(
    "N,kk", N_MATRIX,
    ids=lambda v: str(v) if isinstance(v, int) else " ".join(v),
)
def test_engine_matrix(oracle, planted_fasta, N, kk):
    """The reference's cross-strategy identity contract (testscript.sh:306-422):
    every -N engine yields byte-identical output."""
    cfg = ["-i", planted_fasta, "-P", PAT, "-N", str(N)] + kk
    if N == 6:
        # raw FASTA -> producer alphabet 256 -> 8 bits/char: seedlen must
        # keep the direct table within 2^25 (the randomized fallback is
        # compiled out of the NOPRIMEGEN oracle build)
        cfg += ["-x", "3"]
    ref = subprocess.run(
        [os.path.join(oracle, "primer_match")] + cfg,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(cfg), buf)
    assert buf.getvalue() == ref


@pytest.fixture(scope="module")
def gs_fasta(tmp_path_factory):
    """Isolated plants of distinct patterns (no suffix overlap): the gapped
    seed engine's lastpos dedup then matches the other engines exactly."""
    rng = random.Random(7)
    pats = ["CATCCTGCATCA", "TGGTAGGAGTTG", "AACCGGTTAACC"]
    seq = [rng.choice("ACGT") for _ in range(20000)]
    pos = 500
    for p in pats:
        for mode in ("exact", "sub1", "sub2"):
            s = list(p)
            if mode == "sub1":
                s[4] = "ACGT"[("ACGT".index(s[4]) + 1) % 4]
            elif mode == "sub2":
                s[2] = "ACGT"[("ACGT".index(s[2]) + 2) % 4]
                s[9] = "ACGT"[("ACGT".index(s[9]) + 1) % 4]
            seq[pos : pos + len(s)] = s
            pos += len(s) + 211
    path = tmp_path_factory.mktemp("gs") / "gs.fasta"
    with open(path, "w") as f:
        f.write(">g1 entry\n")
        s = "".join(seq)
        for i in range(0, len(s), 70):
            f.write(s[i : i + 70] + "\n")
    with open(path.parent / "pats.txt", "w") as f:
        f.write(" ".join(pats) + "\n")
    return str(path), str(path.parent / "pats.txt")


def test_gapped_seed_engine(gs_fasta):
    """-N 15 (gapped seed set): the reference's gs path is compiled out of
    NOPRIMEGEN builds; on isolated plants its verified hit stream must match
    the oracle-verified hash_table engine's byte for byte."""
    db, patf = gs_fasta
    for kk in (["-K", "1"], ["-K", "2"], ["-K", "2", "-r"]):
        cfg = ["-i", db, "-P", patf]
        b15 = io.StringIO()
        run(parse_args(cfg + ["-N", "15"] + kk), b15)
        b6 = io.StringIO()
        run(parse_args(cfg + ["-N", "6", "-x", "6"] + kk), b6)
        assert b15.getvalue() == b6.getvalue()
        assert b15.getvalue()
