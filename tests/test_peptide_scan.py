"""peptide_scan byte parity vs the reference binary: protein scan, 6-frame
translated DNA scan, DNA-substitution scoring, AA equivalence maps."""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.peptide_scan import parse_args, run

AAS = "ACDEFGHIKLMNPQRSTVWY"
PEPS = ["MKTAYIAKQR", "LLDFGAKHE", "WWSPNNVTK", "GGIEDELK"]

_CODON = {}
_bases = "TCAG"
_aa = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_i = 0
for _b1 in _bases:
    for _b2 in _bases:
        for _b3 in _bases:
            _CODON.setdefault(_aa[_i], _b1 + _b2 + _b3)
            _i += 1
_RC = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _enc(p):
    return "".join(_CODON[c] for c in p)


def _rc(s):
    return "".join(_RC[c] for c in reversed(s))


@pytest.fixture(scope="module")
def pep_files(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("pep")
    rng = random.Random(21)
    entries = ["".join(rng.choice(AAS) for _ in range(2000))
               for _ in range(3)]
    e0 = list(entries[0])
    e0[100 : 100 + len(PEPS[0])] = PEPS[0]
    e0[400 : 400 + len(PEPS[1])] = PEPS[1]
    sub = list(PEPS[2])
    sub[4] = "A"
    e0[800 : 800 + len(sub)] = sub
    entries[0] = "".join(e0)
    e1 = list(entries[1])
    e1[50 : 50 + len(PEPS[3])] = PEPS[3]
    entries[1] = "".join(e1)
    prot = d / "prot.fasta"
    with open(prot, "w") as f:
        for i, s in enumerate(entries):
            f.write(f">prot{i} test protein {i}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60] + "\n")

    dna = list("".join(rng.choice("ACGT") for _ in range(6000)))
    d0 = _enc(PEPS[0])
    dna[300 : 300 + len(d0)] = d0
    d1 = _enc(PEPS[1])
    dna[1501 : 1501 + len(d1)] = d1
    d2 = _rc(_enc(PEPS[2]))
    dna[3000 : 3000 + len(d2)] = d2
    dnaf = d / "dna.fasta"
    with open(dnaf, "w") as f:
        f.write(">dna1 test dna entry\n")
        s = "".join(dna)
        for j in range(0, len(s), 70):
            f.write(s[j : j + 70] + "\n")

    pf = d / "peps.txt"
    with open(pf, "w") as f:
        f.write("\n".join(PEPS) + "\n")

    # translation requires a normalized database (select.t raw-file path
    # warns "Can't translate from raw sequence database")
    for path in (prot, dnaf):
        subprocess.run(
            [os.path.join(oracle, "compress_seq"), "-i", str(path), "-n",
             "true"],
            check=True, capture_output=True,
        )
    return str(prot), str(dnaf), str(pf)


PROT_CONFIGS = [
    [],
    ["-K", "1"],
    ["-K", "2"],
    ["-C", "4"],
    ["-M", "2"],
    ["-M", "3"],
    ["-M", "2", "-K", "1"],
]

DNA_CONFIGS = [
    ["-T", "A"],
    ["-T", "F"],
    ["-T", "A", "-K", "1"],
    ["-T", "A", "-K", "2"],
    ["-T", "A", "-C", "3"],
    ["-T", "A", "-M", "2"],
    ["-T", "A", "-M", "3", "-K", "1"],
    ["-T", "F", "-K", "1"],
]


def _check(oracle, db, pf, cfg):
    args = ["-i", db, "-P", pf] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "peptide_scan")] + args,
        capture_output=True, text=True, check=True,
    ).stdout
    buf = io.StringIO()
    run(parse_args(args), buf)
    assert buf.getvalue() == ref


@pytest.mark.parametrize("cfg", PROT_CONFIGS,
                         ids=lambda c: " ".join(c) or "plain")
def test_protein_parity(oracle, pep_files, cfg):
    prot, _dna, pf = pep_files
    _check(oracle, prot, pf, cfg)


@pytest.mark.parametrize("cfg", DNA_CONFIGS, ids=lambda c: " ".join(c))
def test_translated_parity(oracle, pep_files, cfg):
    _prot, dna, pf = pep_files
    _check(oracle, dna, pf, cfg)
