"""allvall family: planted near-duplicate detection, chunk/merge
invariance (the file-level map-reduce), and bitmap format interop with the
reference binaries."""

import os
import random
import subprocess

import numpy as np
import pytest

from sequence_alignment_tools.apps.allvall import (
    allvall_main, dump_main, merge_main, read_bitmap, tobm_main,
    write_bitmap,
)


@pytest.fixture(scope="module")
def av_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("allvall")
    rng = random.Random(77)
    db = "".join(rng.choice("ACGT") for _ in range(1200))
    bg1 = "".join(rng.choice("ACGT") for _ in range(900))
    bg2 = "".join(rng.choice("ACGT") for _ in range(900))
    bg1 = bg1[:300] + db[100:140] + bg1[340:]
    d2 = list(db[600:640])
    d2[20] = "ACGT"[("ACGT".index(d2[20]) + 1) % 4]
    bg2 = bg2[:500] + "".join(d2) + bg2[540:]

    def wf(name, s):
        p = d / name
        with open(p, "w") as f:
            f.write(f">x {name}\n")
            for i in range(0, len(s), 60):
                f.write(s[i : i + 60] + "\n")
        return str(p)

    q = wf("q.fasta", db)
    a = wf("bgA.fasta", bg1)
    b = wf("bgB.fasta", bg2)
    full = d / "bgF.fasta"
    full.write_text(open(a).read() + open(b).read())
    return q, a, b, str(full), str(d)


def test_planted_duplicates(av_files):
    q, a, b, full, d = av_files
    out = os.path.join(d, "t1.bm")
    allvall_main(["-i", q, "-b", full, "-m", "20", "-K", "1",
                  "-o", out, "-A"])
    bits, _s, _p = read_bitmap(out)
    # exact plant db[100:140] -> flat mer ends 121..141 all marked
    assert bits[121:142].all()
    # 1-mismatch plant db[600:640] -> marked under -K 1
    assert bits[621:642].all()
    # a random region has no matches
    assert not bits[300:420].any()


def test_chunk_merge_invariance(av_files):
    """OR of per-background-part bitmaps == the single full run — the
    multi-process decomposition the reference ships (allvall_merge)."""
    q, a, b, full, d = av_files
    outs = []
    for name, bgf in (("full", full), ("pa", a), ("pb", b)):
        out = os.path.join(d, f"m_{name}.bm")
        if os.path.exists(out):
            os.unlink(out)  # allvall resumes from existing outputs
        allvall_main(["-i", q, "-b", bgf, "-m", "20", "-K", "1",
                      "-o", out, "-A"])
        outs.append(out)
    merged = os.path.join(d, "m_merged.bm")
    merge_main(["-i", outs[1], "-i", outs[2], "-o", merged, "-A"])
    f, _, _ = read_bitmap(outs[0])
    g, _, _ = read_bitmap(merged)
    assert (f == g).all()
    assert f.sum() > 20  # found something beyond the preset prefix


def test_binary_roundtrip(av_files, tmp_path):
    q, a, b, full, d = av_files
    rng = np.random.default_rng(5)
    bits = rng.random(5000) < 0.1
    pb = tmp_path / "x.bm"
    with open(pb, "wb") as f:
        write_bitmap(f, bits, ascii_out=False, span=3, pos=77)
    got, span, pos = read_bitmap(str(pb))
    assert (got == bits).all() and span == 3 and pos == 77
    # tobm binary -> ascii -> binary
    pa = tmp_path / "x_a.bm"
    tobm_main(["-i", str(pb), "-o", str(pa), "-A"])
    got2, _, _ = read_bitmap(str(pa))
    assert (got2 == bits).all()


def test_dump_interop_with_reference(av_files, oracle, tmp_path):
    """The reference allvall_dump must read our bitmap byte-for-byte."""
    dump = os.path.join(oracle, "allvall_dump")
    cseq = os.path.join(oracle, "compress_seq")
    if not os.access(dump, os.X_OK):
        pytest.skip("allvall_dump oracle unavailable")
    q, a, b, full, d = av_files
    out = os.path.join(d, "t1.bm")
    if not os.path.exists(out):
        allvall_main(["-i", q, "-b", full, "-m", "20", "-K", "1",
                      "-o", out, "-A"])
    # the oracle needs a normalized '$'-EOS database for seeking
    subprocess.run([cseq, "-i", q, "-E", "36", "-n", "true"],
                   check=True, capture_output=True)
    ref = subprocess.run([dump, "-i", q, "-d", out, "-m", "20"],
                         capture_output=True, text=True).stdout
    import io
    import sys

    buf = io.StringIO()
    stdout = sys.stdout
    sys.stdout = buf
    try:
        dump_main(["-i", q, "-d", out, "-m", "20"])
    finally:
        sys.stdout = stdout
    assert buf.getvalue() == ref
    assert ref.startswith(">")


def test_merge_interop_with_reference(av_files, oracle, tmp_path):
    """The reference allvall_merge must parse and merge our bitmaps (ascii
    and binary) into output our reader parses."""
    mrg = os.path.join(oracle, "allvall_merge")
    if not os.access(mrg, os.X_OK):
        pytest.skip("allvall_merge oracle unavailable")
    rng = np.random.default_rng(9)
    x = rng.random(3000) < 0.05
    y = rng.random(3000) < 0.05
    px, py = tmp_path / "x.bm", tmp_path / "y.bm"
    with open(px, "wb") as f:
        write_bitmap(f, x, ascii_out=True)
    with open(py, "wb") as f:
        write_bitmap(f, y, ascii_out=False)
    pz = tmp_path / "z.bm"
    subprocess.run([mrg, "-o", str(pz), str(px), str(py)],
                   check=True, capture_output=True)
    z, _, _ = read_bitmap(str(pz))
    assert (z == (x | y)).all()
