"""pairscan checkpoint-bitmap byte parity vs the reference, including the
64-bit template truncation / x86 shift-wrap region (spans > 32-2m chars,
hash.cc shiftspaced), resume from an existing checkpoint, and the -e
early-exit status."""

import os
import random
import subprocess

import pytest

from sequence_alignment_tools.apps.pairscan import main as ps_main


@pytest.fixture(scope="module")
def compressed(tmp_path_factory, oracle):
    d = tmp_path_factory.mktemp("ps")
    rng = random.Random(31)
    fa = d / "ps.fasta"
    with open(fa, "w") as f:
        for e in range(3):
            s = "".join(rng.choice("ACGT") for _ in range(400))
            f.write(f">p{e} pair {e}\n{s}\n")
    subprocess.run(
        [os.path.join(oracle, "compress_seq"), "-i", str(fa), "-n", "true"],
        check=True, capture_output=True)
    return str(fa)


def _oracle(oracle, db, out, args):
    ps = os.path.join(oracle, "pairscan")
    if not os.access(ps, os.X_OK):
        pytest.skip("pairscan oracle unavailable")
    return subprocess.run([ps, "-i", db, "-o", out] + args,
                          capture_output=True).returncode


CONFIGS = [
    ["-m", "4", "-d", "0", "-D", "10"],
    ["-m", "5", "-d", "0", "-D", "6"],
    ["-m", "4", "-d", "3", "-D", "8"],
    # spans past the 64-bit template register: truncation + mask wrap
    ["-m", "4", "-d", "20", "-D", "30"],
    ["-m", "6", "-d", "0", "-D", "3"],
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c))
def test_bitmap_parity(oracle, compressed, tmp_path, cfg):
    ref, mine = str(tmp_path / "r.bm"), str(tmp_path / "m.bm")
    rrc = _oracle(oracle, compressed, ref, cfg)
    mrc = ps_main(["-i", compressed, "-o", mine] + cfg)
    assert (rrc, open(ref, "rb").read()) == (mrc, open(mine, "rb").read())


def test_resume(oracle, compressed, tmp_path):
    ref, mine = str(tmp_path / "r.bm"), str(tmp_path / "m.bm")
    for D in ("5", "10"):
        cfg = ["-m", "4", "-d", "0", "-D", D]
        _oracle(oracle, compressed, ref, cfg)
        ps_main(["-i", compressed, "-o", mine] + cfg)
    assert open(ref, "rb").read() == open(mine, "rb").read()


def test_exitthresh(oracle, compressed, tmp_path):
    ref, mine = str(tmp_path / "r.bm"), str(tmp_path / "m.bm")
    cfg = ["-m", "4", "-d", "0", "-D", "10", "-e", "100000"]
    rrc = _oracle(oracle, compressed, ref, cfg)
    mrc = ps_main(["-i", compressed, "-o", mine] + cfg)
    assert rrc == mrc == 2
    assert open(ref, "rb").read() == open(mine, "rb").read()
