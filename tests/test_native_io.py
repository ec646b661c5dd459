"""Native data-path components vs their pure-Python oracles.

- native/fasta_pack.cpp (one-sweep FASTA pass 1) vs io.fasta.iter_fasta /
  io.compress._read_raw — adversarial layouts: \r\n, '>' mid-line, data
  before the first defline, whitespace-only lines, missing trailing newline,
  empty entries, weird bytes.
- native/sais.cpp (SA-IS) vs the prefix-doubling builder — random, periodic,
  constant, and tiny strings.
"""

import os
import random

import numpy as np
import pytest

from sequence_alignment_tools.io.compress import (
    _build_suffix_array_numpy,
    build_suffix_array,
)
from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.fasta import native_pass1
from sequence_alignment_tools.native import load_fasta_lib, load_sais_lib

pytestmark = pytest.mark.skipif(
    load_fasta_lib() is None or load_sais_lib() is None,
    reason="native toolchain unavailable",
)


ADVERSARIAL = [
    b"",
    b"\n\n\n",
    b">only header, no sequence",
    b">h1\nACGT\nacgt\n>h2\nTTTT",          # no trailing newline
    b"ACGT\nGGGG\n>named\nCCCC\n",          # data before first '>'
    b"   \n>h\nACGT\n",                     # whitespace-only pre-header line
    b">h\r\nAC GT\r\nA\tC\r\n",             # \r\n + interior whitespace
    b">\nACGT\n",                           # empty defline
    b">h1\n>h2\nAC\n",                      # empty entry
    b">h\nAC>GT\n",                         # '>' mid-line is sequence data
    b">h\nAC\x01G\x7fT\xffZ\n",             # out-of-range bytes (mode 1 drops)
    b">h\r\r\nACGT\r\r\n",                  # multiple trailing \r
    b">h\nACGT",                            # EOF inside sequence
    b">a\n\n\nAC\n\n>b\nGT\n",              # blank lines inside an entry
]


def _rand_fasta(rng: random.Random) -> bytes:
    out = []
    if rng.random() < 0.3:
        out.append(rng.choice([b"ACGT\n", b"  \n", b"\n", b"xy z\r\n"]))
    for _ in range(rng.randrange(0, 5)):
        hdr = bytes(
            rng.choice(b"abcXYZ >\t_0123") for _ in range(rng.randrange(0, 8))
        )
        out.append(b">" + hdr + rng.choice([b"\n", b"\r\n", b"\r\r\n"]))
        for _ in range(rng.randrange(0, 4)):
            line = bytes(
                rng.choice(b"ACGTacgtnN \t\x01\x7f>*-")
                for _ in range(rng.randrange(0, 12))
            )
            out.append(line + rng.choice([b"\n", b"\r\n"]))
    data = b"".join(out)
    if data.endswith(b"\n") and rng.random() < 0.3:
        data = data[:-1]
    return data


def _write(tmp_path, data: bytes) -> str:
    p = os.path.join(str(tmp_path), "t.fasta")
    with open(p, "wb") as f:
        f.write(data)
    return p


def _pass1_oracle(path, filter_mode, uppercase, eos_between, eos_start,
                  eos_char):
    """iter_fasta-based reconstruction of the native pass-1 outputs."""
    from sequence_alignment_tools.io.fasta import iter_fasta

    parts, starts, lengths, headers = [], [], [], []
    pos = 0
    if eos_start and eos_between:
        parts.append(np.array([eos_char], np.uint8))
        pos += 1
    for header, seq in iter_fasta(path):
        arr = np.frombuffer(seq, dtype=np.uint8)
        if filter_mode == 1:
            arr = arr[(arr >= 33) & (arr <= 126)]
        if uppercase:
            low = (arr >= ord("a")) & (arr <= ord("z"))
            arr = np.where(low, arr - 32, arr).astype(np.uint8)
        starts.append(pos)
        lengths.append(len(arr))
        headers.append(header)
        parts.append(arr)
        pos += len(arr)
        if eos_between:
            parts.append(np.array([eos_char], np.uint8))
            pos += 1
    raw = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    return raw, np.asarray(starts, np.int64), np.asarray(lengths, np.int64), \
        headers


@pytest.mark.parametrize("data", ADVERSARIAL)
@pytest.mark.parametrize("filter_mode", [0, 1])
def test_fasta_pack_adversarial(tmp_path, data, filter_mode):
    path = _write(tmp_path, data)
    got = native_pass1(path, filter_mode, True, True, True, ord("\n"))
    assert got is not None
    raw, starts, lengths, headers = got
    eraw, estarts, elengths, eheaders = _pass1_oracle(
        path, filter_mode, True, True, True, ord("\n"))
    assert headers == eheaders
    np.testing.assert_array_equal(raw, eraw)
    np.testing.assert_array_equal(starts, estarts)
    np.testing.assert_array_equal(lengths, elengths)


def test_fasta_pack_fuzz(tmp_path):
    rng = random.Random(7)
    for case in range(120):
        data = _rand_fasta(rng)
        path = _write(tmp_path, data)
        fm = rng.randrange(2)
        up = bool(rng.randrange(2))
        eb = bool(rng.randrange(2)) if case % 3 else True
        es = bool(rng.randrange(2))
        got = native_pass1(path, fm, up, eb, es, ord("\n"))
        assert got is not None, data
        exp = _pass1_oracle(path, fm, up, eb, es, ord("\n"))
        assert got[3] == exp[3], data
        np.testing.assert_array_equal(got[0], exp[0], err_msg=repr(data))
        np.testing.assert_array_equal(got[1], exp[1], err_msg=repr(data))
        np.testing.assert_array_equal(got[2], exp[2], err_msg=repr(data))


def test_from_fasta_native_matches_python(tmp_path):
    rng = random.Random(11)
    for _ in range(40):
        data = _rand_fasta(rng)
        path = _write(tmp_path, data)
        db_native = SeqDB.from_fasta(path)
        db_py = SeqDB.from_entries(
            list(__import__(
                "sequence_alignment_tools.io.fasta", fromlist=["iter_fasta"]
            ).iter_fasta(path))
        )
        assert db_native.table == db_py.table, repr(data)
        np.testing.assert_array_equal(db_native.codes, db_py.codes)
        np.testing.assert_array_equal(
            db_native.entry_starts, db_py.entry_starts)
        np.testing.assert_array_equal(
            db_native.entry_lengths, db_py.entry_lengths)
        assert db_native.headers == db_py.headers


def test_read_raw_native_matches_python(tmp_path):
    from sequence_alignment_tools.io import compress as C

    rng = random.Random(13)
    for _ in range(30):
        data = _rand_fasta(rng)
        path = _write(tmp_path, data)
        got = C._read_raw(path, True, True, ord("\n"), True)
        os.environ["SAT_NO_NATIVE"] = "1"
        try:
            exp = C._read_raw(path, True, True, ord("\n"), True)
        finally:
            del os.environ["SAT_NO_NATIVE"]
        np.testing.assert_array_equal(got[0], exp[0], err_msg=repr(data))
        assert got[1] == exp[1]
        np.testing.assert_array_equal(got[2], exp[2])
        np.testing.assert_array_equal(got[3], exp[3])
        assert list(got[4]) == list(exp[4])


# ---------------------------------------------------------------------------
# SA-IS


def test_sais_small_cases():
    for codes in [
        [0], [0, 0, 0, 0], [3, 2, 1, 0], [0, 1, 0, 1, 0, 1],
        [1], [1, 0], [0, 1], [2, 2, 1, 2, 2, 1, 2],
        list(b"mmiissiissiippii"), list(b"banana"),
    ]:
        arr = np.asarray(codes, dtype=np.uint8)
        np.testing.assert_array_equal(
            build_suffix_array(arr), _build_suffix_array_numpy(arr),
            err_msg=str(codes))


def test_sais_fuzz():
    rng = np.random.default_rng(3)
    for trial in range(60):
        n = int(rng.integers(1, 400))
        alpha = int(rng.integers(1, [3, 5, 255][trial % 3] + 1))
        codes = rng.integers(0, alpha, size=n).astype(np.uint8)
        if trial % 7 == 0:  # periodic text stresses the LMS recursion
            codes = np.tile(codes[: max(n // 8, 1)], 8)[:n]
        np.testing.assert_array_equal(
            build_suffix_array(codes), _build_suffix_array_numpy(codes))


def test_sais_is_used_and_fast():
    # a 1M-char DNA-ish text: SA-IS must agree with prefix doubling
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=1 << 20).astype(np.uint8)
    sa = build_suffix_array(codes)
    # spot-check: sampled ranks are genuinely sorted suffixes
    idx = rng.integers(0, len(codes) - 1, size=512)
    for i in idx:
        a, b = int(sa[i]), int(sa[i + 1])
        sl = min(64, len(codes) - max(a, b))
        ca, cb = codes[a : a + sl].tobytes(), codes[b : b + sl].tobytes()
        assert ca <= cb
