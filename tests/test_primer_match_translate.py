"""primer_match -T byte parity vs the reference binary: peptide patterns
against the 6-frame translated DNA stream with frame-mapped coordinates
(primer_match.cc:229-230 option, :1026-1031 reversed patterns,
:1160-1232 frame + coordinate math, :1296 rev-row counts gate)."""

import io
import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.primer_match import parse_args, run

AAS = "ACDEFGHIKLMNPQRSTVW"  # no Y: keeps random pep hits unambiguous
PEPS = ["MKTAYIAK", "LLDFGAKHE", "WWSPNNVT", "GGIEDELK"]

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
def tr_files(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("pmt")
    rng = random.Random(77)
    dna = list("".join(rng.choice("ACGT") for _ in range(9000)))
    # forward hits in all three frames
    for frame, (pos, pep) in enumerate(
            [(300, PEPS[0]), (1501, PEPS[1]), (2702, PEPS[2])]):
        enc = _enc(pep)
        dna[pos : pos + len(enc)] = enc
    # reverse-strand hits (the translated stream's reverse frames carry
    # them REVERSED, matched by the reversed pattern array)
    r0 = _rc(_enc(PEPS[3]))
    dna[4000 : 4000 + len(r0)] = r0
    r1 = _rc(_enc(PEPS[0]))
    dna[5201 : 5201 + len(r1)] = r1
    dnaf = d / "dna.fasta"
    with open(dnaf, "w") as f:
        f.write(">dna1 translated primer_match entry\n")
        s = "".join(dna)
        for j in range(0, len(s), 70):
            f.write(s[j : j + 70] + "\n")
    pf = d / "peps.txt"
    with open(pf, "w") as f:
        f.write("\n".join(PEPS) + "\n")
    # translation requires a normalized database (select.t:163-164)
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(dnaf), "-n",
         "true"],
        check=True, capture_output=True,
    )
    return str(dnaf), str(pf)


CONFIGS = [
    ["-T", "-c"],
    ["-T", "-c", "-a"],
    ["-T"],
    ["-T", "-A", "%i %s %e %S %E %d %r%R %F %n %q %t %f\n"],
    ["-T", "-k", "1", "-c"],
    ["-T", "-K", "1", "-c"],
    ["-T", "-r", "-c"],  # -r is absorbed by -T's pattern doubling
]


def _check(oracle, db, pf, cfg):
    args = ["-i", db, "-P", pf] + cfg
    for _try in range(3):  # oracle exit-time abort retry
        r = subprocess.run(
            [os.path.join(oracle, "primer_match")] + args,
            capture_output=True, text=True,
        )
        if r.returncode == 0 or r.stdout:
            break
    ref = r.stdout
    buf = io.StringIO()
    run(parse_args(args), buf)
    assert buf.getvalue() == ref


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c))
def test_translate_parity(oracle, tr_files, cfg):
    dna, pf = tr_files
    _check(oracle, dna, pf, cfg)
