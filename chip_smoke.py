#!/usr/bin/env python3
"""Start-up proof on the GPU: the device routes of primer_match, pcr_match
and peptide_scan, compiled for the card and checked against the host
machines.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded exact and -k 1
                                   # scans against one device, nothing else

Phases (one card), each a child process run after the previous one exits,
so one process holds the card at a time (this parent never imports JAX):

1. device    JAX's platform must be ``gpu``; prints the card, JAX version.
2. data      a ~250 Mbase synthetic genome (GRCh38 chr1 is 248,956,422 bp)
             in several entries with N runs, the 10 bench primers planted
             on both strands exactly and with 1-2 edits, a 16 Mbase slice,
             STS pairs and peptides — all from ``--seed``.
3. kernels   each device route at real width against the host machines:
             the microhit filter in both emit modes (exact and -K 1), the
             gated k=1 pipeline and the k=2 Sellers scan; filter timing.
4. gpu-tests the ``gpu``-marked pytest battery (tests/test_gpu.py).
5. cli       primer_match at -k 0, -K 1, -k 1 and -k 2 on the genome,
             pcr_match and peptide_scan on the slice, through the normal
             entry point with the host machines disabled: output must be
             byte-identical to the host-routed run, and the ``Route:``
             lines must name the GPU device route.  One run goes through
             the site-less ``sat`` launcher.

Every time printed carries the card's name and power limit.  The last
line of standard output is ``{"ok": true, "device": {...}}``; a failed
phase exits nonzero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "sequence_alignment_tools"
PRIMERS = [
    "AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
    "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "AAGAAAAGGGGGAAA",
    "TCATGAAGTAAAC", "TTGGCTGCTGCCCCCAG", "AGAAAAGGGGGAAA",
    "CTATTGATAAGGGAGTG",
]
GENOME_BASES = 250_000_000
SLICE_BASES = 16_000_000
ENTRIES = 8

# Route lines that mean a scan left the GPU device route
HOST_ROUTES = ("native shift-and host machine", "XLA block-scan fallback",
               "native Sellers row machine", "host radix census",
               "native threaded mer-hash census", "host radix-code census")
DEVICE_ROUTES = ("fused microhit scan pipeline", "fused gated pipeline",
                 "XLA Sellers whole-array scan",
                 "fused microhit pipeline sharded", "gated pipeline sharded")


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd, env=None, timeout=600, stdout=None):
    """Run a child to completion; raise PhaseError on a nonzero exit."""
    full = dict(os.environ)
    full.update(env or {})
    r = subprocess.run(cmd, cwd=HERE, env=full, timeout=timeout,
                       stdout=stdout or subprocess.PIPE,
                       stderr=subprocess.PIPE)
    if r.returncode != 0:
        raise PhaseError("%s exited %d:\n%s" % (
            " ".join(cmd[:4]), r.returncode,
            r.stderr.decode(errors="replace")[-3000:]))
    return r


def card_label() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise PhaseError("nvidia-smi failed: " + r.stderr[-500:])
    return r.stdout.strip().splitlines()[0]


# -- phase 1: the device -----------------------------------------------------

_DEVICE_CHILD = """
import json, jax
d = jax.devices()
print(json.dumps({"platform": d[0].platform, "kind": d[0].device_kind,
                  "count": len(d), "jax": jax.__version__}))
"""


def phase_device(want: int) -> dict:
    r = run([sys.executable, "-c", _DEVICE_CHILD], timeout=300)
    dev = json.loads(r.stdout.decode().strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        raise PhaseError("JAX found no GPU (platform %r)" % dev["platform"])
    if dev["count"] < want:
        raise PhaseError("%d GPUs visible, %d needed" % (dev["count"], want))
    return dev


# -- phase 2: data -------------------------------------------------------------

_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def _mutate(rng, s: str, edits: int, indels: bool) -> str:
    b = list(s)
    for _ in range(edits):
        i = int(rng.integers(1, len(b) - 1))
        op = int(rng.integers(0, 3)) if indels else 0
        if op == 0:
            b[i] = "ACGT"[("ACGT".index(b[i]) + 1 + int(rng.integers(0, 3)))
                          % 4]
        elif op == 1:
            del b[i]
        else:
            b.insert(i, "ACGT"[int(rng.integers(0, 4))])
    return "".join(b)


# the standard genetic code, codons in TCAG order
_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def _translate(dna: str) -> str:
    out = []
    for i in range(0, len(dna) - 2, 3):
        c = dna[i : i + 3]
        if any(b not in "TCAG" for b in c):
            out.append("X")
        else:
            out.append(_CODE[16 * "TCAG".index(c[0]) + 4 * "TCAG".index(c[1])
                             + "TCAG".index(c[2])])
    return "".join(out)


def _write_fasta(path: str, entries) -> None:
    import numpy as np

    with open(path, "wb") as f:
        for name, seq in entries:
            f.write(b">%s synthetic entry\n" % name.encode())
            n = len(seq)
            full = n - n % 60
            if full:
                f.write(np.concatenate(
                    [seq[:full].reshape(-1, 60),
                     np.full((full // 60, 1), ord("\n"), np.uint8)],
                    axis=1).tobytes())
            if n % 60:
                f.write(seq[full:].tobytes() + b"\n")


def phase_data(work: str, seed: int, bases: int) -> dict:
    """The genome, its slice and the pattern files; returns their paths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = lut[rng.integers(0, 4, size=bases, dtype=np.uint8)]
    # N runs: assembly gaps of 1-50 kb
    for _ in range(40):
        at = int(rng.integers(0, bases - 60_000))
        genome[at : at + int(rng.integers(1_000, 50_000))] = ord("N")
    # planted primers, both strands, exact and with 1-2 edits
    per = bases // (len(PRIMERS) * 12 + 1)
    slot = per // 2
    for p in PRIMERS:
        for strand in (p, _revcomp(p)):
            for variant in (strand, _mutate(rng, strand, 1, False),
                            _mutate(rng, strand, 1, True),
                            _mutate(rng, strand, 2, True),
                            strand, strand):
                genome[slot : slot + len(variant)] = np.frombuffer(
                    variant.encode(), np.uint8)
                slot += per
    cuts = np.linspace(0, bases, ENTRIES + 1).astype(np.int64)
    paths = {
        "genome": os.path.join(work, "genome.fasta"),
        "slice": os.path.join(work, "slice.fasta"),
        "primers": os.path.join(work, "primers.txt"),
        "pairs": os.path.join(work, "pairs.txt"),
        "peptides": os.path.join(work, "peptides.txt"),
    }
    _write_fasta(paths["genome"], [
        ("chr%d" % (i + 1), genome[cuts[i] : cuts[i + 1]])
        for i in range(ENTRIES)])
    sl = genome[:SLICE_BASES]
    _write_fasta(paths["slice"], [("slice1", sl[: SLICE_BASES // 2]),
                                  ("slice2", sl[SLICE_BASES // 2 :])])
    with open(paths["primers"], "w") as f:
        f.write("\n".join(PRIMERS) + "\n")
    # STS pairs with real amplicons in the slice
    text = sl.tobytes().decode()
    pairs = []
    x = 100_000
    while len(pairs) < 20 and x < SLICE_BASES - 2_000:
        fwd, rev = text[x : x + 18], text[x + 700 : x + 718]
        if "N" not in fwd + rev:
            pairs += [fwd, _revcomp(rev)]
        x += 700_000
    with open(paths["pairs"], "w") as f:
        f.write("\n".join(pairs) + "\n")
    # peptides from a forward-frame translation of the slice
    peps = []
    x = 200_000
    while len(peps) < 10 and x < SLICE_BASES - 100:
        pep = _translate(text[x : x + 27])
        if len(pep) == 9 and pep.isalpha() and "X" not in pep:
            peps.append(pep)
        x += 1_300_003
    with open(paths["peptides"], "w") as f:
        f.write("\n".join(peps) + "\n")
    return paths


# -- phase 3: kernels at real width ------------------------------------------

_KERNELS_CHILD = r'''
import json, sys, time
import numpy as np
import jax, jax.numpy as jnp
from sequence_alignment_tools.io.compress import load_db
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.models.primer_match import PrimerMatchModel
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.host_scan import HostShiftAnd
from sequence_alignment_tools.ops.microhit import filter_weights, microhits
from sequence_alignment_tools.ops.sellers import SellersScanner
from sequence_alignment_tools.ops.tables import build_tables

genome, primers, label = sys.argv[1:4]
db = load_db(genome)
codes = np.asarray(db.codes)
n = len(codes)
pats = [l.strip() for l in open(primers) if l.strip()]
ps = build_pattern_set(pats, rev_comp=True)
t = build_tables(ps, db, wc=False, textn=False)
print("genome: %d positions, %d patterns, Lmax %d, alphabet %d"
      % (n, t.P, t.Lmax, t.alpha), flush=True)
ok = True

def check(name, good, detail=""):
    global ok
    ok &= bool(good)
    print("%s %s %s" % ("PASS" if good else "FAIL", name, detail), flush=True)

def timed(f, reps=10):
    jax.block_until_ready(f())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps

dev = jnp.asarray(codes)
pad = max(t.eos_code, 0)
hosts = {}
for k in (0, 1):
    poison = k > 0
    want = sorted(HostShiftAnd(t, k, poison).scan(codes))
    hosts[k] = want
    sc = ConvScanner(t, k=k, poison_eos=poison)
    sc.use_host = False
    check("route k=%d is the fused pipeline" % k, sc.use_fused)
    got = sorted(sc.scan(codes))
    check("microhit occupancy pipeline %s == host shift-and"
          % ("exact" if k == 0 else "-K 1"), got == want,
          "(%d hits)" % len(want))
    W, thr, cls = filter_weights(t, k, poison, fold=False)
    W, thr = jnp.asarray(W), jnp.asarray(thr)
    f = jax.jit(lambda c: microhits(c, W, thr, classes=cls, pad=pad,
                                    emit="pos"))
    word = np.asarray(f(dev))[:n]
    by = {}
    for e, p, _m in want:
        by.setdefault(e - int(t.lengths[p]), []).append(p)
    live = np.flatnonzero(word >= 0)
    exact = set(live.tolist()) == set(by) and all(
        (word[s] & 255) == len(v) and (word[s] >> 8) == max(v)
        for s, v in by.items())
    check("microhit pos words %s == host shift-and"
          % ("exact" if k == 0 else "-K 1"), exact)

W, thr, cls = filter_weights(t, 0, False)
W, thr = jnp.asarray(W), jnp.asarray(thr)
xla = jax.jit(lambda c: microhits(c, W, thr, classes=cls, pad=pad))
occ = np.asarray(xla(dev))
starts = np.asarray([e - t.lengths[p] for e, p, _m in hosts[0]])
check("XLA occupancy covers every host hit", occ[starts // 32].all())
ms_xla = 1e3 * timed(lambda: xla(dev))
print("time microhit filter XLA, %d Mbases: %.3f ms [%s]"
      % (n // 10**6, ms_xla, label), flush=True)
for name, k in (("gated k=1 pipeline", 1),):
    m_dev = PrimerMatchModel(db, ps, k=k, mesh=None)
    m_dev.use_host = False
    _o, sc, *_r = m_dev._halves_ctx()
    check("route k=1 is the gated pipeline", sc.gated_available(n))
    t0 = time.perf_counter()
    got = list(m_dev.engine_hits())
    t1 = time.perf_counter()
    m_host = PrimerMatchModel(db, ps, k=k, mesh=None)
    m_host.use_host = True
    want = list(m_host.engine_hits())
    check(name + " == host engine", got == want, "(%d hits)" % len(want))
    print("time %s engine run, first call: %.2f s [%s]"
          % (name, t1 - t0, label), flush=True)

sc = SellersScanner(t, k=2, indels=True)
check("route k=2 is the device Sellers scan", sc.device_available(n))
t0 = time.perf_counter()
e, p = sc.scan_pairs(codes)
t1 = time.perf_counter()
h = SellersScanner(t, k=2, indels=True)
h.use_host = True
he, hp = h.host_pairs(codes) if h._host_eligible(n) else (None, None)
check("Sellers k=2 == native Sellers row machine", he is not None and
      sorted(zip(e.tolist(), p.tolist()))
      == sorted(zip(he.tolist(), hp.tolist())), "(%d pairs)" % len(e))
print("time Sellers k=2 scan, first call: %.2f s [%s]"
      % (t1 - t0, label), flush=True)
st = jax.devices()[0].memory_stats() or {}
print("peak device bytes %s of %s" % (st.get("peak_bytes_in_use"),
                                      st.get("bytes_limit")), flush=True)
sys.exit(0 if ok else 1)
'''


def phase_kernels(paths: dict, label: str) -> None:
    r = run([sys.executable, "-c", _KERNELS_CHILD, paths["genome"],
             paths["primers"], label], timeout=900)
    sys.stdout.write(r.stdout.decode())


# -- phase 4: the gpu-marked tests ---------------------------------------------

def phase_gpu_tests() -> None:
    r = run([sys.executable, "-m", "pytest", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", "tests/test_gpu.py"],
            env={"SAT_TEST_PLATFORM": "gpu"}, timeout=900)
    log(r.stdout.decode().strip().splitlines()[-1])


# -- phase 5: the CLI --------------------------------------------------------

# host-routed reference: the same entry point with every scanner pinned
# to the native host machines, on the CPU platform
_HOST_CHILD = r'''
import sys
from sequence_alignment_tools.ops.conv_scan import ConvScanner
from sequence_alignment_tools.ops.sellers import SellersScanner
ConvScanner.use_host = True
SellersScanner.use_host = True
from sequence_alignment_tools.__main__ import main
sys.argv = ["sequence_alignment_tools"] + sys.argv[1:]
sys.exit(main())
'''


def _cli(work, tag, args, host=False, launcher=False, mesh="1"):
    """Run one CLI invocation; returns (stdout path, Route lines)."""
    out = os.path.join(work, tag + ".out")
    if host:
        cmd = [sys.executable, "-c", _HOST_CHILD] + args
        env = {"JAX_PLATFORMS": "cpu", "SAT_MESH": "0"}
    else:
        cmd = ([sys.executable, "-S", os.path.join(HERE, "sat")] if launcher
               else [sys.executable, "-m", PKG]) + args
        env = {"SAT_HOST_SCAN": "0", "SAT_ROUTE_VERBOSE": "1",
               "SAT_MESH": mesh}
    env["SAT_AUTO_ARTIFACTS"] = "1"
    with open(out, "wb") as f:
        r = run(cmd, env=env, timeout=900, stdout=f)
    routes = [ln.split("Route: ", 1)[1]
              for ln in r.stderr.decode(errors="replace").splitlines()
              if "Route: " in ln]
    return out, routes


def _same(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _check_routes(tag, routes, sharded=False):
    bad = [r for r in routes if r.startswith(HOST_ROUTES)]
    good = [r for r in routes if r.startswith(DEVICE_ROUTES)]
    if sharded:
        good = [r for r in good if "sharded" in r]
    if bad or not good:
        raise PhaseError("%s: routes %r do not name the GPU device route"
                         % (tag, routes))
    return good


def phase_cli(work: str, paths: dict, label: str) -> None:
    g, pr = paths["genome"], paths["primers"]
    jobs = [
        ("primer_match -k 0", ["primer_match", "-i", g, "-P", pr, "-r"]),
        ("primer_match -K 1", ["primer_match", "-i", g, "-P", pr, "-r",
                               "-K", "1"]),
        ("primer_match -k 1", ["primer_match", "-i", g, "-P", pr, "-r",
                               "-k", "1"]),
        ("primer_match -k 2", ["primer_match", "-i", g, "-P", pr, "-r",
                               "-k", "2"]),
        ("pcr_match", ["pcr_match", "-i", paths["slice"], "-P",
                       paths["pairs"], "-r", "-M", "2000"]),
        ("peptide_scan 6-frame", ["peptide_scan", "-i", paths["slice"],
                                  "-P", paths["peptides"], "-T", "A"]),
    ]
    for i, (name, args) in enumerate(jobs):
        t0 = time.perf_counter()
        dev_out, routes = _cli(work, "dev%d" % i, args)
        t1 = time.perf_counter()
        host_out, _ = _cli(work, "host%d" % i, args, host=True)
        t2 = time.perf_counter()
        good = _check_routes(name, routes)
        size = os.path.getsize(dev_out)
        if not size or not _same(dev_out, host_out):
            raise PhaseError("%s: device output (%d bytes) differs from "
                             "the host-routed run" % (name, size))
        log("PASS %s: %d bytes identical to the host route; route %r; "
            "device run %.1f s, host run %.1f s [%s]"
            % (name, size, good[0], t1 - t0, t2 - t1, label))
    out, routes = _cli(work, "sat0", jobs[0][1], launcher=True)
    good = _check_routes("sat launcher", routes)
    if not _same(out, os.path.join(work, "dev0.out")):
        raise PhaseError("sat launcher output differs from python -m")
    log("PASS python -S sat primer_match -k 0 reaches the GPU (route %r)"
        % good[0])


def phase_four(work: str, paths: dict, label: str) -> None:
    g, pr = paths["genome"], paths["primers"]
    for name, extra in (("exact", []), ("-k 1", ["-k", "1"])):
        args = ["primer_match", "-i", g, "-P", pr, "-r"] + extra
        t0 = time.perf_counter()
        one, r1 = _cli(work, "one" + name, args, mesh="1")
        t1 = time.perf_counter()
        four, r4 = _cli(work, "four" + name, args, mesh="4")
        t2 = time.perf_counter()
        _check_routes("one device " + name, r1)
        good = _check_routes("four devices " + name, r4, sharded=True)
        if not os.path.getsize(one) or not _same(one, four):
            raise PhaseError("4-device %s output differs from 1 device"
                             % name)
        log("PASS sharded %s over 4 GPUs: %d bytes identical to one "
            "device; route %r; 1-device run %.1f s, 4-device run %.1f s "
            "[%s]" % (name, os.path.getsize(one), good[0], t1 - t0,
                      t2 - t1, label))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, PKG)):
        log("FAIL: %s not found beside chip_smoke.py" % PKG)
        return 2
    want = 4 if opts.four else 1
    work = os.path.join(HERE, ".smoke")
    t_all = time.perf_counter()
    try:
        dev = phase_device(want)
        label = card_label()
        log("card: %s" % label)
        log("device: %s x%d, jax %s" % (dev["kind"], dev["count"],
                                        dev["jax"]))
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        t0 = time.perf_counter()
        sys.path.insert(0, HERE)
        paths = phase_data(work, opts.seed, GENOME_BASES)
        log("data: %d Mbase genome in %d entries + %d Mbase slice, seed "
            "%d, %.1f s [%s]" % (GENOME_BASES // 10**6, ENTRIES,
                                 SLICE_BASES // 10**6, opts.seed,
                                 time.perf_counter() - t0, label))
        phases = ([("four", lambda: phase_four(work, paths, label))]
                  if opts.four else
                  [("kernels", lambda: phase_kernels(paths, label)),
                   ("gpu-tests", phase_gpu_tests),
                   ("cli", lambda: phase_cli(work, paths, label))])
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            log("phase %s done in %.1f s [%s]"
                % (name, time.perf_counter() - t0, label))
    except (PhaseError, subprocess.TimeoutExpired, OSError,
            ValueError) as e:
        log("FAIL: %s" % e)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("all phases passed in %.1f s [%s]"
        % (time.perf_counter() - t_all, label))
    count = want if opts.four else 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
