"""Verbose/observability stderr protocol parity (-v) vs the reference.

The reference's tracing subsystem is the ``timestamp*`` macro family
(util.h:55-61) plus the throttled progress reporter
(pattern_match.h:135-155).  Every verbose line is
``[<asctime>] <message>`` on stderr; the message sequence is fixed by
primer_match.cc:856-1332 (driver milestones), select.t:29-188 (database
representation pick) and select.cc:149-278 (primer stats, options
summary, strategy announcement).  Timestamps and progress cadence are
run-dependent, so parity here = identical message streams after
stripping the 24-char asctime prefix and ``Progress:`` lines.
"""

import contextlib
import io
import os
import re
import subprocess

import pytest

from sequence_alignment_tools.apps.primer_match import parse_args, run

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")
TS = re.compile(r"^\[.{24}\] ")
PROGRESS = re.compile(r"^Progress: *\d+\.\d%$")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import random

    rng = random.Random(23)
    pats = [l.strip() for l in open(PAT) if l.strip()]
    seq = [rng.choice("ACGT") for _ in range(40000)]
    pos = 700
    for p in pats:
        seq[pos : pos + len(p)] = list(p)
        pos += len(p) + 211
    path = tmp_path_factory.mktemp("vb") / "corpus.fasta"
    with open(path, "w") as f:
        f.write(">v1 verbose corpus\n")
        for i in range(0, len(seq), 70):
            f.write("".join(seq[i : i + 70]) + "\n")
    return str(path)


def _ours(cfg):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        run(parse_args(cfg), out)
    return out.getvalue(), err.getvalue()


def _clean(stderr_text):
    """Strip asctime prefixes, drop progress lines; assert line format.

    'Route:' lines are framework-native kernel-route announcements
    (VERDICT r2 item 10) — the reference has none, so they filter out
    of the parity comparison exactly like throttled Progress lines."""
    msgs = []
    for line in stderr_text.splitlines():
        assert TS.match(line), f"untimestamped stderr line: {line!r}"
        msg = TS.sub("", line)
        if not msg.startswith(("Progress:", "Route:")):
            msgs.append(msg)
    return msgs


CONFIGS = [
    ["-v"],
    ["-v", "-r"],
    ["-v", "-r", "-k", "1"],
    ["-v", "-K", "1", "-c"],
    ["-v", "-k", "1", "-s", "6"],
    ["-v", "-B", "-r", "-K", "2"],
    ["-v", "-u", "-k", "1", "-N", "5"],
    ["-v", "-k", "1", "-x", "6"],
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: " ".join(c))
def test_verbose_stderr_parity(oracle, corpus, cfg):
    full = ["-i", corpus, "-P", PAT] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "primer_match")] + full,
        capture_output=True, text=True, check=True,
    )
    got_out, got_err = _ours(full)
    assert got_out == ref.stdout
    ref_msgs = [TS.sub("", l) for l in ref.stderr.splitlines()
                if not TS.sub("", l).startswith("Progress:")]
    assert _clean(got_err) == ref_msgs


def test_route_lines(corpus):
    """-v names the actual kernel route taken (VERDICT r2 item 10): the
    route announcement appears once per scanner, timestamped."""
    _, err = _ours(["-i", corpus, "-P", PAT, "-v", "-r", "-k", "2"])
    routes = [TS.sub("", l) for l in err.splitlines()
              if TS.sub("", l).startswith("Route:")]
    assert routes, "no Route: line under -v"
    assert len(routes) == len(set(routes))  # once per route


def test_progress_lines(oracle, corpus):
    """Progress lines render exactly like report_progress
    (pattern_match.h:144-155): 'Progress:' + %5.1f + '%', ending at 100."""
    _, err = _ours(["-i", corpus, "-P", PAT, "-v", "-r"])
    prog = [TS.sub("", l) for l in err.splitlines()
            if TS.sub("", l).startswith("Progress:")]
    assert prog, "no progress lines emitted"
    assert all(PROGRESS.match(p) for p in prog)
    assert prog[-1] == "Progress:100.0%"


def test_verbose_empty_patterns_exits_zero(corpus):
    """-v skips the usage check; no patterns -> Release Tag then exit 0
    (primer_match.cc:274,927-929)."""
    out, err = _ours(["-i", corpus, "-v"])
    assert out == ""
    assert _clean(err) == ["Release Tag: $Name:  $"]


@pytest.fixture(scope="module")
def pcr_corpus(tmp_path_factory):
    """Corpus with planted amplicons for six primer pairs."""
    import random

    rng = random.Random(5)
    rc = {"A": "T", "C": "G", "G": "C", "T": "A"}
    seq = [rng.choice("ACGT") for _ in range(60000)]
    pairs = []
    pos = 1000
    for _ in range(6):
        f = "".join(rng.choice("ACGT") for _ in range(20))
        r = "".join(rng.choice("ACGT") for _ in range(20))
        pairs.append((f, r))
        amp = (f + "".join(rng.choice("ACGT") for _ in range(200))
               + "".join(rc[c] for c in reversed(r)))
        seq[pos : pos + len(amp)] = list(amp)
        pos += len(amp) + 500
    d = tmp_path_factory.mktemp("pcrv")
    fasta = d / "corpus.fasta"
    with open(fasta, "w") as fo:
        fo.write(">pc test corpus\n")
        s = "".join(seq)
        for i in range(0, len(s), 70):
            fo.write(s[i : i + 70] + "\n")
    patf = d / "pairs.txt"
    with open(patf, "w") as fo:
        for f, r in pairs:
            fo.write(f + " " + r + "\n")
    return str(fasta), str(patf)


PCR_CONFIGS = [
    ["-v", "-r"],
    ["-v", "-k", "1"],
    ["-v", "-K", "1", "-B"],
    ["-v", "-k", "1", "-x", "6"],
    ["-V", "-u"],
]


@pytest.mark.parametrize("cfg", PCR_CONFIGS, ids=lambda c: " ".join(c))
def test_pcr_verbose_stderr_parity(oracle, pcr_corpus, cfg):
    from sequence_alignment_tools.apps.pcr_match import (
        parse_args as pcr_parse,
        run as pcr_run,
    )

    fasta, patf = pcr_corpus
    full = ["-i", fasta, "-P", patf] + cfg
    ref = subprocess.run(
        [os.path.join(oracle, "pcr_match")] + full,
        capture_output=True, text=True, check=True,
    )
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        pcr_run(pcr_parse(full), out)
    assert out.getvalue() == ref.stdout
    ref_msgs = [TS.sub("", l) for l in ref.stderr.splitlines()
                if not TS.sub("", l).startswith("Progress:")]
    assert _clean(err.getvalue()) == ref_msgs


def test_progress_reporter_throttles():
    from sequence_alignment_tools.utils.log import ProgressReporter

    buf = io.StringIO()
    rep = ProgressReporter(0.25, stream=buf)
    for frac in (0.1, 0.2, 0.3, 0.4, 0.6, 0.7, 1.0):
        rep.report(frac)
    msgs = [TS.sub("", l) for l in buf.getvalue().splitlines()]
    # report when frac > pcur, then pcur = frac + interval
    # (pattern_match.h:144-155): 0.1 -> 0.4 -> 0.7 -> 1.0
    assert msgs == ["Progress: 10.0%", "Progress: 40.0%",
                    "Progress: 70.0%", "Progress:100.0%"]
