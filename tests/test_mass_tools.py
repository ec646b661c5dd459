"""Byte parity for peptide_mult and aacomp/aacomplookup."""

import io
import os
import random
import re
import subprocess

import pytest

from sequence_alignment_tools.apps.aacomp import (
    aacomp_main, aacomplookup_main,
)
from sequence_alignment_tools.apps.peptide_mult import (
    parse_args as pm_args, run as pm_run,
)

MASSES = """G 57.02146
A 71.03711
S 87.03203
P 97.05276
V 99.06841
T 101.04768
C 103.00919
L 113.08406
I 113.08406
N 114.04293
D 115.02694
Q 128.05858
K 128.09496
E 129.04259
M 131.04049
H 137.05891
F 147.06841
R 156.10111
Y 163.06333
W 186.07931
n 1.00794
c 17.00274
"""


@pytest.fixture(scope="module")
def mass_fixture(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("mass")
    rng = random.Random(31)
    AAS = "ACDEFGHIKLMNPQRSTVWY"
    entries = ["".join(rng.choice(AAS) for _ in range(400))
               for _ in range(3)]
    entries[1] = "M" + entries[1][1:]
    e2 = list(entries[2])
    e2[50], e2[120], e2[200] = "X", "B", "Z"
    entries[2] = "".join(e2)
    fasta = d / "prot.fasta"
    with open(fasta, "w") as f:
        for i, s in enumerate(entries):
            f.write(f">q{i} prot {i}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60] + "\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(fasta), "-n",
         "true"], check=True, capture_output=True,
    )
    massf = d / "mass.txt"
    massf.write_text(MASSES)
    mass = {t.split()[0]: float(t.split()[1]) for t in MASSES.splitlines()}

    def pepmass(p):
        return mass["n"] + sum(mass[c] for c in p) + mass["c"]

    peps = re.findall(r"[^KR]*[KR]|[^KR]+$", entries[0])
    qf = d / "queries.txt"
    with open(qf, "w") as f:
        qs = [(1000 + i, i + 1, round(pepmass(p), 3))
              for i, p in enumerate(peps[:4])]
        f.write("1 " + " ".join(f"{q} {r} {m}" for q, r, m in qs) + "\n")
        f.write("2 2001 1 800.5 2002 2 1200.25\n")
        f.write("3 3001 1 900.0\n")
    return str(fasta), str(massf), str(qf)


PM_CONFIGS = [["-e", "2"], ["-e", "0.1"], ["-e", "0.01", "-r"],
              ["-C", "2"], ["-C", "0"], ["-X"], ["-X", "-e", "5"]]


@pytest.mark.parametrize("cfg", PM_CONFIGS, ids=lambda c: " ".join(c))
def test_peptide_mult_parity(oracle, mass_fixture, cfg):
    fasta, massf, qf = mass_fixture
    args = ["-i", fasta, "-I", qf, "-m", massf] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "peptide_mult")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    pm_run(pm_args(args), buf)
    assert buf.getvalue() == ref


def test_aacomp_parity(oracle, mass_fixture, tmp_path, monkeypatch):
    fasta, _massf, _qf = mass_fixture
    ac = os.path.join(oracle, "aacomp")
    if not os.access(ac, os.X_OK):
        pytest.skip("aacomp oracle unavailable")
    rbin = tmp_path / "r.bin"
    obin = tmp_path / "o.bin"
    subprocess.run([ac, "-i", fasta, "-M", "600", "-o", str(rbin)],
                   check=True, capture_output=True)
    aacomp_main(["-i", fasta, "-M", "600", "-o", str(obin)])
    assert rbin.read_bytes() == obin.read_bytes()

    lk = os.path.join(oracle, "aacomplookup")
    if not os.access(lk, os.X_OK):
        pytest.skip("aacomplookup oracle unavailable")
    queries = "250.5\n410.2\n300.0\n"
    ref = subprocess.run([lk, "-i", str(rbin), "-t", "0.5"],
                         input=queries, capture_output=True, text=True,
                         check=True).stdout
    import sys
    out = tmp_path / "o.txt"
    monkeypatch.setattr(sys, "stdin", io.StringIO(queries))
    aacomplookup_main(["-i", str(rbin), "-t", "0.5", "-o", str(out)])
    assert out.read_text() == ref
