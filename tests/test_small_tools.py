"""Byte parity for the small drivers: exact_match, inexact_match, and the
compress_seq CLI's check/rebuild semantics."""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.exact_match import (
    parse_args as em_args, run as em_run,
)
from sequence_alignment_tools.apps.inexact_match import (
    parse_args as im_args, run as im_run,
)

PATS = ["CATCCTGCATCA", "TGGTAGGAGTTG", "AACCGGTTAACC"]
RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _rc(s):
    return "".join(RC[c] for c in reversed(s))


@pytest.fixture(scope="module")
def em_fasta(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("em")
    rng = random.Random(7)
    seq = [rng.choice("ACGT") for _ in range(20000)]
    pos = 500
    for p in PATS:
        for v in (p, _rc(p)):
            seq[pos : pos + len(v)] = list(v)
            pos += len(v) + 211
        s2 = list(p)
        s2[4] = "ACGT"[("ACGT".index(s2[4]) + 1) % 4]
        seq[pos : pos + len(s2)] = s2
        pos += len(s2) + 211
    s = "".join(seq)
    path = d / "pl.fasta"
    with open(path, "w") as f:
        f.write(">e1 first\n")
        for i in range(0, 12000, 60):
            f.write(s[i : i + 60] + "\n")
        f.write(">e2 second\n")
        for i in range(12000, len(s), 60):
            f.write(s[i : i + 60] + "\n")
    patf = d / "pats.txt"
    with open(patf, "w") as f:
        f.write(" ".join(PATS) + "\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(path), "-n", "true"],
        check=True, capture_output=True,
    )
    return str(path), str(patf)


EM_CONFIGS = [["-q"], [], ["-r", "-q"], ["-r"], ["-b", "-q"], ["-k"]]


@pytest.mark.parametrize("cfg", EM_CONFIGS, ids=lambda c: " ".join(c) or "d")
def test_exact_match_parity(oracle, em_fasta, cfg):
    db, patf = em_fasta
    args = ["-i", db, "-P", patf] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "exact_match")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    em_run(em_args(args), buf)
    assert buf.getvalue() == ref


IM_CONFIGS = [
    ["-k", "0", "-q"],
    ["-k", "1", "-q"],
    ["-k", "1"],
    ["-k", "2", "-q"],
    ["-r", "-k", "1", "-q"],
    ["-k", "1", "-r"],
]


@pytest.mark.parametrize("cfg", IM_CONFIGS, ids=lambda c: " ".join(c))
def test_inexact_match_parity(oracle, em_fasta, cfg):
    db, patf = em_fasta
    args = ["-i", db, "-P", patf] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "inexact_match")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    im_run(im_args(args), buf)
    assert buf.getvalue() == ref


def test_compress_seq_cli(tmp_path, oracle):
    """Our CLI's artifacts must be byte-identical to the oracle's, and -c
    must report staleness correctly."""
    import shutil

    from sequence_alignment_tools.apps.compress_seq import main as cs_main

    src = tmp_path / "x.fasta"
    rng = random.Random(3)
    with open(src, "w") as f:
        for e in range(3):
            f.write(f">s{e} entry {e}\n")
            s = "".join(rng.choice("ACGT") for _ in range(997))
            for i in range(0, len(s), 61):
                f.write(s[i : i + 61] + "\n")
    ours = tmp_path / "ours"
    theirs = tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    shutil.copy(src, ours / "x.fasta")
    shutil.copy(src, theirs / "x.fasta")
    assert cs_main(["-i", str(ours / "x.fasta"), "-n", "true", "-z", "true",
                    "-C", "false"]) == 0
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(theirs / "x.fasta"),
         "-n", "true", "-z", "true", "-C", "false"],
        check=True, capture_output=True,
    )
    for ext in (".seq", ".hdr", ".idb", ".tbl", ".sqn", ".tbz", ".sqz"):
        a = (ours / ("x.fasta" + ext)).read_bytes()
        b = (theirs / ("x.fasta" + ext)).read_bytes()
        assert a == b, f"artifact {ext} differs"
    # -c true: up to date -> 0
    assert cs_main(["-i", str(ours / "x.fasta"), "-n", "true", "-z", "true",
                    "-c", "true"]) == 0
    # touch source -> rebuild needed -> 1
    os.utime(ours / "x.fasta")
    assert cs_main(["-i", str(ours / "x.fasta"), "-n", "true", "-z", "true",
                    "-c", "true"]) == 1


@pytest.fixture(scope="module")
def ka_env(tmp_path_factory, oracle):
    """Raw FASTA + kmer_count aggregate tables (text and binary)."""
    d = tmp_path_factory.mktemp("ka")
    rng = random.Random(11)
    fa = d / "anno.fasta"
    with open(fa, "w") as f:
        for e in range(4):
            n = 200 + 37 * e
            s = "".join(rng.choice("ACGT") for _ in range(n))
            f.write(f">r{e} entry {e} desc\n")
            for i in range(0, n, 57):
                f.write(s[i : i + 57] + "\n")
    txt, binf = d / "mers.txt", d / "mers.bin"
    for extra, outf in (([], txt), (["-b"], binf)):
        # kmer_count aborts nondeterministically at exit — retry
        for _ in range(10):
            r = subprocess.run(
                [os.path.join(oracle, "kmer_count"), "-i", str(fa),
                 "-k", "6", "-a", *extra, "-o", str(outf)],
                capture_output=True)
            if r.returncode == 0:
                break
        else:
            raise AssertionError("kmer_count oracle never exited cleanly")
    return str(fa), str(txt), str(binf)


KA_CONFIGS = [["-k", "6"], ["-k", "6", "-n"], ["-k", "6", "-b"]]


@pytest.mark.parametrize("cfg", KA_CONFIGS, ids=lambda c: " ".join(c))
def test_kmer_annotate_parity(oracle, ka_env, cfg):
    from sequence_alignment_tools.apps.kmer_annotate import (
        parse_args as ka_args, run as ka_run,
    )

    fa, txt, binf = ka_env
    table = binf if "-b" in cfg else txt
    args = ["-m", table, "-s", fa] + cfg
    # the reference aborts nondeterministically at exit (cleanup
    # double-free) — retry until a clean run
    for _ in range(10):
        r = subprocess.run(
            [os.path.join(oracle, "kmer_annotate")] + args,
            capture_output=True, text=True,
        )
        if r.returncode == 0:
            break
    else:
        raise AssertionError("kmer_annotate oracle never exited cleanly")
    ref = r.stdout
    buf = io.StringIO()
    ka_run(ka_args(args), buf)
    assert buf.getvalue() == ref
    assert len(ref) > 100  # non-degenerate


def test_suffix_tree_engine(tmp_path, oracle):
    """compress_seq -t persists a suffix array; its presence flips
    primer_match's -N 1..3 / auto exact path to the suftree engine,
    whose emission is (end asc, registration asc) — the hit SET matches
    the keyword tree exactly.  (The reference's own .st query path is
    bit-rotted and reports spurious hits at every position.)"""
    import random

    from sequence_alignment_tools.apps.compress_seq import main as cs
    from sequence_alignment_tools.apps.primer_match import (
        parse_args as pm_args, run as pm_run,
    )
    from sequence_alignment_tools.io.compress import (
        build_suffix_array, read_suffix_array,
    )
    from sequence_alignment_tools.io.compress import load_db
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel, select_engine,
    )
    from sequence_alignment_tools.io.patterns import build_pattern_set

    rng = random.Random(3)
    pats = ["CATCCTGCATCA", "TGGTAGGAGTTG"]
    seq = [rng.choice("ACGT") for _ in range(9000)]
    for i, p in enumerate(pats):
        for rep in range(3):
            at = 400 + 2500 * i + 700 * rep
            seq[at : at + len(p)] = list(p)
    src = tmp_path / "st.fasta"
    with open(src, "w") as f:
        f.write(">s1 entry\n")
        s = "".join(seq)
        for i in range(0, len(s), 70):
            f.write(s[i : i + 70] + "\n")
    assert cs(["-i", str(src), "-n", "true", "-t", "true"]) == 0
    assert (tmp_path / "st.fasta.sqn.st").exists()
    sa = read_suffix_array(str(tmp_path / "st.fasta.sqn.st"))
    db = load_db(str(src))
    assert (sa == build_suffix_array(db.codes)).all()
    assert db.has_suffix_tree
    ps = build_pattern_set(pats, rev_comp=True)
    assert select_engine(db, ps, 0, False, 0, 0) == "suftree"
    assert select_engine(db, ps, 0, False, 0, 3) == "suftree"
    # suftree vs keyword tree: same hit set
    st_hits = sorted(PrimerMatchModel(db, ps, k=0, node=1).engine_hits())
    db2 = load_db(str(src))
    db2.has_suffix_tree = False
    kt_hits = sorted(PrimerMatchModel(db2, ps, k=0, node=1).engine_hits())
    assert st_hits == kt_hits and len(st_hits) == 6
    # end-to-end CLI still works with the artifact present
    import io as _io

    buf = _io.StringIO()
    pm_run(pm_args(["-i", str(src), "-p", " ".join(pats), "-c"]), buf)
    assert "3" in buf.getvalue()
