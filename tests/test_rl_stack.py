"""RL/PeptideScan side-stack tools: Indexer, IndexerAA (and, below,
Xspace/XspaceLo/WordGraph/solid_assembly as they land) — byte parity vs
the reference binaries."""

import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.indexer import main as ix_main
from sequence_alignment_tools.apps.indexer import main_aa as ixaa_main


@pytest.fixture(scope="module")
def mixed_fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("rl")
    path = d / "mix.fasta"
    rng = random.Random(17)
    with open(path, "w") as f:
        f.write(">e1 first entry\nACGTacgtNRYu\nGGGTTT\n")
        f.write(">e2 second\nTTTTaaaa\n")
        f.write(">e3 third AA\nMKVLpqrst.*xB\n")
        s = "".join(rng.choice("ACGTacgtn") for _ in range(300))
        f.write(">e4 random\n" + "\n".join(
            s[i:i + 61] for i in range(0, len(s), 61)) + "\n")
    return str(path)


def _require(oracle, name):
    p = os.path.join(oracle, name)
    if not os.access(p, os.X_OK):
        pytest.skip(f"{name} oracle unavailable")
    return p


def test_indexer_parity(oracle, mixed_fasta, tmp_path):
    ref = _require(oracle, "Indexer")
    r = tmp_path / "r"
    m = tmp_path / "m"
    subprocess.run(
        [ref, "-i", f"{r}.idx", "-f", f"{r}.fwd", "-r", f"{r}.rev",
         mixed_fasta], check=True, capture_output=True)
    assert ix_main(["-i", f"{m}.idx", "-f", f"{m}.fwd", "-r", f"{m}.rev",
                    mixed_fasta]) == 0
    for ext in (".idx", ".fwd", ".rev"):
        assert open(f"{m}{ext}", "rb").read() == \
            open(f"{r}{ext}", "rb").read(), ext


@pytest.fixture(scope="module")
def dna_indexed(tmp_path_factory, oracle):
    """Random DNA (with lowercase and Ns) run through the oracle Indexer."""
    d = tmp_path_factory.mktemp("xsp")
    rng = random.Random(77)
    fa = d / "big.fasta"
    with open(fa, "w") as f:
        for e in range(6):
            n = 400 + 100 * e
            s = "".join(rng.choice("ACGTACGTacgtN") for _ in range(n))
            f.write(f">r{e} rand {e}\n")
            for i in range(0, n, 61):
                f.write(s[i:i + 61] + "\n")
    ref = _require(oracle, "Indexer")
    b = str(d / "b")
    subprocess.run([ref, "-i", f"{b}.idx", "-f", f"{b}.fwd", "-r",
                    f"{b}.rev", str(fa)], check=True, capture_output=True)
    return b


XS_CONFIGS = [["-m", "6"], ["-m", "6", "-a"], ["-m", "3", "-a"],
              ["-m", "10"], ["-m", "4"]]


@pytest.mark.parametrize("cfg", XS_CONFIGS, ids=lambda c: " ".join(c))
def test_xspace_parity(oracle, dna_indexed, tmp_path, cfg):
    from sequence_alignment_tools.apps.xspace import xspace_main

    ref = _require(oracle, "Xspace")
    b = dna_indexed
    r, m = str(tmp_path / "r.out"), str(tmp_path / "m.out")
    subprocess.run([ref, *cfg, "-i", f"{b}.idx", "-f", f"{b}.fwd",
                    "-o", r], check=True, capture_output=True)
    assert xspace_main([*cfg, "-i", f"{b}.idx", "-f", f"{b}.fwd",
                        "-o", m]) == 0
    assert open(m).read() == open(r).read()


LO_CONFIGS = [["-k", "6"], ["-k", "6", "-R"], ["-k", "3", "-R"],
              ["-k", "4", "-M", "1"], ["-k", "4", "-M", "1", "-R"]]


@pytest.mark.parametrize("cfg", LO_CONFIGS, ids=lambda c: " ".join(c))
def test_xspacelo_parity(oracle, dna_indexed, tmp_path, cfg):
    """Incl. revcomp streaming and multi-block plans (-M 1)."""
    from sequence_alignment_tools.apps.xspace import xspacelo_main

    ref = _require(oracle, "XspaceLo")
    b = dna_indexed
    cfg = [("-r" if c == "-R" else c) for c in cfg]
    if "-r" in cfg:
        cfg[cfg.index("-r") + 1:cfg.index("-r") + 1] = [f"{b}.rev"]
    r, m = str(tmp_path / "r.out"), str(tmp_path / "m.out")
    subprocess.run([ref, *cfg, "-i", f"{b}.idx", "-f", f"{b}.fwd",
                    "-o", r], check=True, capture_output=True)
    assert xspacelo_main([*cfg, "-i", f"{b}.idx", "-f", f"{b}.fwd",
                          "-o", m]) == 0
    assert open(m).read() == open(r).read()


def test_xspace_amino(oracle, tmp_path):
    from sequence_alignment_tools.apps.xspace import (xspace_main,
                                                          xspacelo_main)

    refi = _require(oracle, "IndexerAA")
    refx = _require(oracle, "Xspace")
    rng = random.Random(5)
    fa = tmp_path / "prot.fasta"
    with open(fa, "w") as f:
        for e in range(3):
            s = "".join(rng.choice("ACDEFGHIKLMNPQRSTVWYxz.")
                        for _ in range(250))
            f.write(f">p{e} prot {e}\n{s}\n")
    b = str(tmp_path / "p")
    subprocess.run([refi, "-i", f"{b}.idx", "-f", f"{b}.seq", str(fa)],
                   check=True, capture_output=True)
    for cfg in (["-m", "3", "-A"], ["-m", "2", "-U"]):
        r, m = str(tmp_path / "r.out"), str(tmp_path / "m.out")
        subprocess.run([refx, *cfg, "-i", f"{b}.idx", "-f", f"{b}.seq",
                        "-o", r], check=True, capture_output=True)
        assert xspace_main([*cfg, "-i", f"{b}.idx", "-f", f"{b}.seq",
                            "-o", m]) == 0
        assert open(m).read() == open(r).read(), cfg
    reflo = _require(oracle, "XspaceLo")
    r, m = str(tmp_path / "rl.out"), str(tmp_path / "ml.out")
    subprocess.run([reflo, "-k", "3", "-A", "-i", f"{b}.idx", "-f",
                    f"{b}.seq", "-o", r], check=True, capture_output=True)
    assert xspacelo_main(["-k", "3", "-A", "-i", f"{b}.idx", "-f",
                          f"{b}.seq", "-o", m]) == 0
    assert open(m).read() == open(r).read()


@pytest.mark.parametrize("extra", [[], ["-U"]], ids=["amino", "upper"])
def test_indexer_aa_parity(oracle, mixed_fasta, tmp_path, extra):
    ref = _require(oracle, "IndexerAA")
    r = tmp_path / "r"
    m = tmp_path / "m"
    subprocess.run(
        [ref, *extra, "-i", f"{r}.idx", "-f", f"{r}.seq", mixed_fasta],
        check=True, capture_output=True)
    assert ixaa_main([*extra, "-i", f"{m}.idx", "-f", f"{m}.seq",
                      mixed_fasta]) == 0
    for ext in (".idx", ".seq"):
        assert open(f"{m}{ext}", "rb").read() == \
            open(f"{r}{ext}", "rb").read(), ext
