"""Benchmark matrix: scan throughput across the reference's headline
regimes, each against a measured reference-C++ anchor on this host.

Prints ONE JSON line:
  {"metric", "value", "unit", "vs_baseline", "matrix": {...}}

- The top-level metric stays the round-1 headline (exact scan, 20-pattern
  primer set, both strands, 16 MB corpus) for cross-round comparability.
- "matrix" adds one row per regime (VERDICT r1 item 1): k=1 / k=2 edit,
  -K 1 substitution-only, peptide 6-frame, pcr_match pair join, a
  50,000-pattern xmers-phase-1-style exact batch, and a 15-symbol
  wide-alphabet wildcard scan.  Each row reports Mbases/s and
  vs_baseline = ours / reference-C++ measured on the same corpus and
  pattern set (anchors cached in bench_baseline.json; delete it to
  re-measure).

Methodology: ours = best-rep marginal scan cost with a RESIDENT database
(the production serving model — tables/uploads built once, every rep
re-runs the full engine including host verify/extend and hit
consumption); reference = binary wall time on its own preprocessed
artifacts (its production model), best of `BEST_OF` runs.
"""

import json
import os
import subprocess
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASELINE_CACHE = os.path.join(HERE, "bench_baseline.json")
CORPUS = "/tmp/sat_bench_corpus.fasta"
WIDE_CORPUS = "/tmp/sat_bench_wide.fasta"
REF = "/tmp/ref"
PATS = [
    "AGAAGCGAGTTCT", "CGCCAGCAGAGTT", "TTTTCTGAGAATCAAG",
    "CTATTGATAAGGGAGTGC", "ATGGCGGTTTTGTCGAA", "AAGAAAAGGGGGAAA",
    "TCATGAAGTAAAC", "TTGGCTGCTGCCCCCAG", "AGAAAAGGGGGAAA",
    "CTATTGATAAGGGAGTG",
]
CORPUS_BASES = 16_000_000
BEST_OF = 3


def make_corpus():
    if os.path.exists(CORPUS) and os.path.getsize(CORPUS) > CORPUS_BASES:
        return
    rng = np.random.default_rng(42)
    with open(CORPUS, "w") as f:
        per_entry = 2_000_000
        for e in range(CORPUS_BASES // per_entry):
            f.write(f">bench{e} synthetic benchmark entry {e}\n")
            seq = rng.integers(0, 4, size=per_entry)
            arr = np.frombuffer(b"ACGT", dtype=np.uint8)[seq]
            s = arr.tobytes().decode()
            for i in range(0, per_entry, 70):
                f.write(s[i : i + 70] + "\n")


def make_wide_corpus():
    """15-symbol corpus: ACGT + 10 IUPAC ambiguity codes at ~2% + EOS —
    exercises the .sqz 4-bit packing regime and the kernel's wide-alphabet
    class planes at bench scale.  Same 16 M bases as every other row
    (round 5): at the old 4 M the row was dominated by per-rep serving
    fixed costs (~0.45 ms measured: dispatch + grouped-fetch RTT), not
    the wide-alphabet kernel it is meant to measure."""
    if os.path.exists(WIDE_CORPUS) and \
            os.path.getsize(WIDE_CORPUS) > CORPUS_BASES:
        return
    rng = np.random.default_rng(43)
    table = np.frombuffer(b"ACGTRYSWKMBDHVN", dtype=np.uint8)
    with open(WIDE_CORPUS, "w") as f:
        per_entry = 4_000_000
        for e in range(4):
            f.write(f">wide{e} wide-alphabet benchmark entry {e}\n")
            base = rng.integers(0, 4, size=per_entry)
            amb = rng.random(per_entry) < 0.02
            base[amb] = rng.integers(4, 15, size=int(amb.sum()))
            s = table[base].tobytes().decode()
            for i in range(0, per_entry, 70):
                f.write(s[i : i + 70] + "\n")


def _corpus_seq():
    from sequence_alignment_tools.io.database import SeqDB

    db = SeqDB.from_fasta(CORPUS)
    codes = np.asarray(db.codes)
    return db, codes


def _best_rep(fn, min_total=6.0, max_reps=24):
    """Best single-rep seconds: fn() once to warm (compiles, caches,
    converged caps), then repeat until min_total seconds or max_reps."""
    fn()
    best = float("inf")
    total = 0.0
    reps = 0
    while (total < min_total and reps < max_reps) or reps < 2:
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        best = min(best, dt)
        total += dt
        reps += 1
    return best


def _ref_seconds(args, min_total=4.0, cap=2400):
    """Best-of wall time of a reference binary run (retried on the known
    nondeterministic exit-time abort; capped — the P=50k regimes run at
    ~0.01 Mb/s and an uncapped anchor measurement could take hours)."""
    best = float("inf")
    runs = 0
    total = 0.0
    while (total < min_total and runs < BEST_OF) or runs < 1:
        t0 = time.perf_counter()
        try:
            r = subprocess.run(args, capture_output=True, timeout=cap)
        except subprocess.TimeoutExpired:
            return None
        dt = time.perf_counter() - t0
        if r.returncode != 0 and not r.stdout:
            runs += 1
            continue  # startup failure; the abort-at-exit case has output
        best = min(best, dt)
        total += dt
        runs += 1
    return best if best < float("inf") else None


def _have_ref(prog="primer_match"):
    path = os.path.join(REF, prog)
    if not os.access(path, os.X_OK):
        script = os.path.join(HERE, "tests", "oracle", "build_reference.sh")
        subprocess.run(["sh", script], capture_output=True)
    return os.access(path, os.X_OK)


SLICE = "/tmp/sat_bench_slice.fasta"


def make_slice(bases=2_000_000):
    """First entries of the bench corpus, for bounded validation runs."""
    if os.path.exists(SLICE) and os.path.getsize(SLICE) > bases:
        return
    out = []
    total = 0
    with open(CORPUS) as f:
        for line in f:
            out.append(line)
            if not line.startswith(">"):
                total += len(line) - 1
            if total >= bases:
                break
    with open(SLICE, "w") as f:
        f.writelines(out)


def validate_row(name, extra, pats=None, corpus=None, prog="primer_match",
                 flags=("-r", "-c")):
    """Row-output insurance (VERDICT r2 item 7, r3 item 6): OUR CLI's
    output (the per-pattern count vector by default) must byte-match the
    reference's on a bounded slice of the bench corpus — a
    silently-wrong route can't post a good number.  The CLI run pins
    the DEVICE posture (``SAT_HOST_SCAN=0`` disables the native host
    router, matching the timed rows' ``use_host=False``), so the
    byte-check exercises the same device pipelines that posted the
    number, not the host fallback.  Failures raise (bench dies
    loudly).  The CLI child opens the device itself, so every
    validation runs before this process does (see main)."""
    if not _have_ref(prog):
        return
    make_slice()
    corpus = corpus or SLICE
    if prog == "peptide_scan" and not os.path.exists(corpus + ".sqn"):
        # translation requires a normalized database (select.t:
        # "Can't translate from raw sequence database")
        subprocess.run(
            [os.path.join(REF, "compress_seq"), "-i", corpus, "-n", "true"],
            capture_output=True, timeout=600)
    patfile = _patfile(pats or PATS, "val_" + name)
    args = ["-i", corpus, "-P", patfile] + list(flags) + extra
    ours = subprocess.run(
        ["python", "-m", f"sequence_alignment_tools.apps.{prog}"]
        + args, capture_output=True, timeout=1200,
        env={**os.environ, "SAT_HOST_SCAN": "0"})
    for _try in range(3):
        ref = subprocess.run([os.path.join(REF, prog)] + args,
                             capture_output=True, timeout=1200)
        if ref.returncode == 0 or ref.stdout:
            break
    assert ours.stdout == ref.stdout, (
        f"bench row {name}: output diverges from the reference\n"
        f"ours:\n{ours.stdout[:2000]!r}\nref:\n{ref.stdout[:2000]!r}")


def bench_oneshot(k):
    """Cold one-shot CLI latency (seconds): a fresh interpreter +
    ``primer_match -c`` over the 16 MB corpus — the reference's usage
    model.  Boots through the shipped site-less ``sat`` launcher; the
    host-native one-shot route never imports jax at all
    (``_LazyJaxBoot``).  The launcher floor lands in the notes.

    Runs before the bench parent opens the device: a child JAX process
    on a card the parent holds would fail for want of memory.  The
    child's output is validated so a crashed run can never post a time.
    ``SAT_AUTO_ARTIFACTS`` lets the CLI persist reference-format
    .seq/.hdr/.idb artifacts on first touch (the reference's own
    production model is compress_seq-preprocessed input)."""
    patfile = _patfile(PATS, "pats")
    tool_args = ["primer_match", "-i", CORPUS, "-P", patfile, "-r",
                 "-c"] + (["-k", str(k)] if k else [])
    env = {**os.environ, "SAT_AUTO_ARTIFACTS": "1"}
    # The shipped cold-start path: the site-less ``sat`` launcher (the
    # host-native one-shot route never imports jax).  Insurance: one
    # sited ``python -m`` run must agree byte-for-byte — the launcher is
    # a boot path, never an output path.
    args = ["python", "-S", os.path.join(HERE, "sat")] + tool_args
    best = float("inf")
    out = None
    for _ in range(2):
        t0 = time.perf_counter()
        r = subprocess.run(args, capture_output=True, timeout=1200,
                           env=env, cwd=HERE)
        dt = time.perf_counter() - t0
        assert r.returncode == 0 and len(r.stdout) > 100, (
            f"one-shot k={k} run failed (rc={r.returncode}): "
            f"{r.stderr[-800:]!r}")
        best = min(best, dt)
        out = r.stdout
    sited = subprocess.run(
        ["python", "-m", "sequence_alignment_tools"] + tool_args,
        capture_output=True, timeout=1200, env=env, cwd=HERE)
    assert sited.returncode == 0 and sited.stdout == out, (
        f"one-shot k={k}: sat launcher output diverges from the sited "
        f"boot (rc={sited.returncode})")
    return best


def bench_floor():
    """The ``sat`` launcher's interpreter floor (``python -S``): the
    irreducible part of every one-shot number."""
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        subprocess.run(["python", "-S", "-c", "pass"], capture_output=True)
        best = min(best, time.perf_counter() - t0)
    return best


def ref_oneshot(k):
    if not _have_ref():
        return None
    patfile = _patfile(PATS, "pats")
    args = [os.path.join(REF, "primer_match"), "-i", CORPUS, "-P",
            patfile, "-r", "-c"] + (["-k", str(k)] if k else [])
    return _ref_seconds(args, min_total=0.0)


def _patfile(pats, name):
    path = f"/tmp/sat_bench_{name}.txt"
    with open(path, "w") as f:
        f.write("\n".join(pats) + "\n")
    return path


# ---------------------------------------------------------------------------
# ours


def bench_scan() -> float:
    """Headline: sustained exact-scan throughput (bases/s) through the
    production path (fused microhit filter + rescore, ops/microhit.py),
    overlapped via scan_stream."""
    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.ops.tables import build_tables

    db = SeqDB.from_fasta(CORPUS)
    ps = build_pattern_set(PATS, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(tables, k=0)
    n = len(db.codes)
    nhits = sum(1 for _ in sc.scan(db.codes))
    for _ in sc.scan_stream(db.codes for _ in range(1)):
        pass
    reps = 768
    best = float("inf")
    for _pass in range(3):
        t0 = time.perf_counter()
        for _i, hits in sc.scan_stream(db.codes for _ in range(reps)):
            nhits = len(hits)
        best = min(best, (time.perf_counter() - t0) / reps)
    del nhits
    return n / best


def _model_bps(db, pats, **kw):
    """bases/s of full PrimerMatchModel engine runs (resident DB), in
    the production SERVING posture: consecutive runs overlap through
    engine_hits_stream (run i+1's device pipeline is in flight during
    run i's host verify/extend — the same overlapped-stream methodology
    as the k=0 headline).  Engines without a streamed path fall back to
    sequential runs inside engine_hits_stream itself."""
    import time as _t

    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    ps = build_pattern_set(pats, rev_comp=True)
    model = PrimerMatchModel(db, ps, **kw)
    model.use_host = False  # resident-DB serving: pin the device paths
    for _ in model.engine_hits_stream(2):  # compile + converge caps
        pass
    n = len(db.codes)
    best = float("inf")
    reps = 64
    total = 0.0
    while total < 6.0 and reps <= 512:
        t0 = _t.perf_counter()
        for _ in model.engine_hits_stream(reps):
            pass
        dt = _t.perf_counter() - t0
        best = min(best, dt / reps)
        total += dt
        reps *= 2
    return n / best


def _stream_bps(db, stream_fn, check=0):
    """bases/s of overlapped engine-run serving via a *_stream(reps)
    generator (see _model_bps)."""
    import time as _t

    for out in stream_fn(2):
        if check:
            assert len(out) >= check
    n = len(db.codes)
    best = float("inf")
    reps = 64
    total = 0.0
    while total < 6.0 and reps <= 512:
        t0 = _t.perf_counter()
        for _ in stream_fn(reps):
            pass
        dt = _t.perf_counter() - t0
        best = min(best, dt / reps)
        total += dt
        reps *= 2
    return n / best


def bench_k_edit(db, k, indels=True):
    return _model_bps(db, PATS, k=k, indels=indels)


def bench_xmers_p50k(db, codes):
    """50,000-pattern exact batch (xmers.cc:821 phase-1 geometry): every
    pattern drawn from the corpus.  Auto-routes to the native threaded
    mer-hash census (a dense correlation costs O(n * P * L) at this
    P)."""
    from sequence_alignment_tools.io.patterns import PatternSet
    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.ops.tables import build_tables

    P, L = 50_000, 20
    step = (len(codes) - L) // P
    text = db.decode(0, min(P * step + L, len(codes)))
    pats = []
    i = 0
    while len(pats) < P:
        p = text[i * step : i * step + L]
        if len(p) == L and p.isalpha():
            pats.append(p)
        else:  # entry-boundary EOS in the window: shift into the entry
            pats.append(text[i * step + L : i * step + 2 * L])
        i += 1
    ps = PatternSet()
    ps.patterns = [""] + pats
    ps.esb = [0] * (P + 1)
    ps.eeb = [0] * (P + 1)
    ps.n_forward = P
    tables = build_tables(ps, db, wc=False, textn=False)
    sc = ConvScanner(tables, k=0)
    sc.use_host = False
    assert tables.P > sc._PBLOCK  # really the huge-P census path

    def run():
        # array-native consumption (scan_seed_arrays) — the serving
        # posture at P=50k: the reference's xmers phase 1 likewise
        # consumes hits as in-process arrays, and a per-hit Python
        # tuple stream costs ~1.5x the census itself at this rate
        # (validate_xmers still checks the tuple path's multiset)
        ends, _pids = sc.scan_seed_arrays(codes)
        assert len(ends) >= 1

    return len(codes) / _best_rep(run), pats


def _expect_divergence(check, knob):
    """Breakage proof for the xmers validators (VERDICT r4 item 2): run ``check`` with SAT_MER_ABLATE=knob —
    which corrupts the NATIVE census/gate path only — and require that
    the validation assertion FIRES.  If it doesn't, the insurance is
    inert and the bench dies loudly."""
    os.environ["SAT_MER_ABLATE"] = knob
    try:
        check()
    except AssertionError:
        return
    finally:
        os.environ.pop("SAT_MER_ABLATE", None)
    raise SystemExit(
        f"bench insurance INERT: SAT_MER_ABLATE={knob} did not trip the "
        "xmers row validation — the validator is not covering the "
        "benched native path")


def _xmers_ps(xp):
    from sequence_alignment_tools.io.patterns import PatternSet

    P = len(xp)
    ps = PatternSet()
    ps.patterns = [""] + xp
    ps.esb = [0] * (P + 1)
    ps.eeb = [0] * (P + 1)
    ps.n_forward = P
    return ps


def validate_xmers(db, codes, xp):
    """xmers_p50k row insurance, covering the path that POSTS the number
    (VERDICT r4 item 2): the native threaded mer-hash census
    (shift_and.cpp::sat_mer_scan) must produce the identical (start,
    pattern) stream to the independent numpy radix census on a slice,
    AND the pattern-blocked device pipeline must agree on the hit
    multiset.  Both proven live: SAT_MER_ABLATE=scan (odd-start hits
    dropped from the native output only) must make this check fire."""
    from collections import Counter

    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.ops.tables import build_tables

    tables = build_tables(_xmers_ps(xp), db, wc=False, textn=False)
    sub = np.ascontiguousarray(codes[: 1 << 21])

    def native_vs_numpy():
        nat = ConvScanner(tables, k=0)
        got = nat._mer_native(nat._by_len(), sub, len(sub))
        assert got is not None, (
            "xmers row: native mer census unavailable — the benched "
            "path would not be the one validated")
        ref = ConvScanner(tables, k=0, use_fused=False)
        ref._mer_native = lambda *a, **kw: None
        want = ref._scan_radix_arrays(ref._by_len(), sub, len(sub))
        assert np.array_equal(got[0], want[0]) and \
            np.array_equal(got[1], want[1]), (
                f"xmers row: native census disagrees with the numpy "
                f"radix census ({len(got[0])} vs {len(want[0])} hits)")

    native_vs_numpy()
    _expect_divergence(native_vs_numpy, "scan")

    dev = ConvScanner(tables, k=0)
    dev.use_host = False
    dev._mer_lib_ok = lambda: False  # pin the DEVICE pipeline (second
    # independent algorithm on the same slice)
    got = Counter((e, p) for e, p, _ in dev.scan(sub))
    host = ConvScanner(tables, k=0, use_fused=False)
    host._mer_native = lambda *a, **kw: None
    want = Counter((e, p) for e, p, _ in host._scan_radix(sub))
    assert got == want, (
        f"xmers row: device pipeline disagrees with the numpy census "
        f"({len(got)} vs {len(want)} hits)")


def validate_xmers_k1(xp):
    """xmers_k1 row insurance (VERDICT r4 item 2: the row previously had
    no validate call at all): the full halves-engine pipeline in the
    row's own geometry — native census + inline mer_gate_pass prefix
    gate + batched native DP — must produce the identical hit list to an
    independent run with the native census disabled (numpy radix census,
    no inline gate; the gate is a superset filter so final output must
    match exactly).  Proven live by deliberate breakage of BOTH native
    phases: SAT_MER_ABLATE=scan (census drops odd-start hits) and
    SAT_MER_ABLATE=gate (gate over-prunes at k=0 tolerance) must each
    make this check fire."""
    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    make_slice()
    sdb = SeqDB.from_fasta(SLICE)
    ps = _xmers_ps(xp)

    def hits(native):
        model = PrimerMatchModel(sdb, ps, k=1, indels=True)
        scanner = model._halves_ctx()[1]
        if not native:
            scanner._mer_native = lambda *a, **kw: None
        out = sorted(model.engine_hits())
        if native:
            assert scanner._mer_tables_c is not None, (
                "xmers_k1 row: the model did not route through the "
                "native mer census — validation would not cover the "
                "benched path")
        return out

    want = hits(False)

    def check():
        assert hits(True) == want, (
            "xmers_k1 row: native census+gate engine output diverges "
            "from the independent ungated numpy-census run")

    check()
    _expect_divergence(check, "scan")
    _expect_divergence(check, "gate")


def bench_xmers_k1(db, codes, xp):
    """50,000-pattern k=1 batch (xmers.cc:821,838-847 phase-2 geometry)
    on a 2 MB slice: the halves engine over 100k half-seeds — the
    huge-P inexact regime the reference serves with exact_halves."""
    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import PatternSet
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    make_slice()
    sdb = SeqDB.from_fasta(SLICE)
    P = len(xp)
    ps = PatternSet()
    ps.patterns = [""] + xp
    ps.esb = [0] * (P + 1)
    ps.eeb = [0] * (P + 1)
    ps.n_forward = P
    model = PrimerMatchModel(sdb, ps, k=1, indels=True)
    n = len(sdb.codes)
    # array-native consumption (engine_hits_arrays), like the p50k row:
    # the reference's xmers phase 2 consumes hits as in-process buffers,
    # and the per-hit tuple stream costs ~0.5 ms per 6k hits here.
    # One-time pin: the array emit must equal the tuple stream (the
    # validator then covers the shared pipeline).
    tup = list(model.engine_hits())
    hes, pids, vals = model.engine_hits_arrays()
    assert tup == list(zip(hes.tolist(), pids.tolist(), vals.tolist())), \
        "xmers_k1: engine_hits_arrays diverges from the tuple stream"

    def run():
        out, _p, _v = model.engine_hits_arrays()
        assert len(out) >= 1

    return n / _best_rep(run, min_total=4.0, max_reps=6), sdb


def pcr_pairs(db):
    """10 STS-style pairs drawn from the corpus (every pair has a real
    amplicon)."""
    from sequence_alignment_tools.utils.iupac import reverse_comp

    text = db.decode(0, 2_000_000)
    pairs = []
    for i in range(10):
        x = 100_000 + 170_000 * i
        fwd = text[x : x + 15]
        rev = reverse_comp(text[x + 800 : x + 815])
        pairs += [fwd, rev]
    return pairs


def bench_pcr(db, pairs):
    """pcr_match pair join, full model incl. the host join."""
    from sequence_alignment_tools.apps.pcr_match import (
        build_pair_pattern_set,
    )
    from sequence_alignment_tools.models.pcr_match import PcrMatchModel

    opts = {"ucdict": False, "rev_comp": True, "fplen": 0, "tplen": 0,
            "stlen": 0, "edlen": 0}
    ps = build_pair_pattern_set(pairs, opts, [], [])
    model = PcrMatchModel(db, ps, k=0, maxdist=2000, rev_comp=True)
    model.inner.use_host = False
    return _stream_bps(db, model.pairs_stream, check=10)


def peptides(db):
    """(6-frame translated db, 10 length-9 peptides read out of the
    forward translation, so real hits exist)."""
    from sequence_alignment_tools.io.translate import translate_db

    tdb = translate_db(db, all_frames=True)
    aa = tdb.aa_db.decode(0, 4_000_000)
    peps = []
    i = 0
    while len(peps) < 10 and i + 9 < len(aa):
        p = aa[i : i + 9]
        if p.isalpha() and "*" not in p and "X" not in p:
            peps.append(p)
        i += 300_000
    return tdb, peps


def bench_peptide(db, tdb, peps):
    """peptide_scan 6-frame: the peptides scanned over all 6 frames."""
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    ps = build_pattern_set(peps)
    model = PrimerMatchModel(tdb.aa_db, ps, k=0)
    model.use_host = False
    # report in DNA bases/s (6 frames cover the corpus twice per strand)
    return _stream_bps(db, model.engine_hits_stream)


def wide_pats(db):
    """10 14-mers drawn from the wide-alphabet corpus."""
    text = db.decode(0, 200_000)
    pats = []
    i = 100
    while len(pats) < 10:
        p = text[i : i + 14]
        if len(p) == 14 and "\n" not in p:
            pats.append(p)
        i += 17_000
    return pats


def bench_wide_wc(db, pats):
    """15-symbol alphabet + IUPAC wildcard patterns (-w): the filter's
    wide-alphabet bit-plane regime at bench scale."""
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )

    ps = build_pattern_set(pats, rev_comp=True)
    model = PrimerMatchModel(db, ps, k=0, wc=True)
    model.use_host = False
    return _stream_bps(db, model.engine_hits_stream)


# ---------------------------------------------------------------------------
# reference anchors


def ref_primer_match(pats, name, extra, corpus=CORPUS):
    if not _have_ref():
        return None
    patfile = _patfile(pats, name)
    dt = _ref_seconds(
        [os.path.join(REF, "primer_match"), "-i", corpus, "-P", patfile,
         "-r", "-c"] + extra)
    return (CORPUS_BASES / dt) if dt else None


def ref_anchor(name, ours_builder):
    """Measure (or recall) a reference anchor in bases/s."""
    cache = {}
    if os.path.exists(BASELINE_CACHE):
        cache = json.load(open(BASELINE_CACHE))
    anchors = cache.setdefault("anchors", {})
    if name in anchors:
        return anchors[name]
    val = ours_builder()
    anchors[name] = val
    with open(BASELINE_CACHE, "w") as f:
        json.dump(cache, f)
    return val


def main():
    make_corpus()
    make_wide_corpus()

    # Children that open the device run FIRST, while this process stays
    # off it (a second JAX process on a held card fails for want of
    # memory): the one-shot rows (VERDICT r2 item 4 / r3 item 4: cold
    # CLI wall seconds) and every row's output validation.
    matrix = {}
    floor_s = bench_floor()
    for name, k in (("oneshot_exact", 0), ("oneshot_k1", 1),
                    ("oneshot_k2", 2)):
        ours_s = bench_oneshot(k)
        ref_s = ref_anchor(name, lambda k=k: ref_oneshot(k))
        matrix[name] = {
            "value": round(ours_s, 2),
            "unit": "s cold wall (lower better)",
            "ref": round(ref_s, 2) if ref_s else None,
            "vs_baseline": round(ref_s / ours_s, 3) if ref_s else 0.0,
        }

    from sequence_alignment_tools.io.database import SeqDB

    db, codes = _corpus_seq()
    pairs = pcr_pairs(db)
    tdb, peps = peptides(db)
    wdb = SeqDB.from_fasta(WIDE_CORPUS)
    wpats = wide_pats(wdb)
    for name, extra in (("k1_edit", ["-k", "1"]), ("k2_edit", ["-k", "2"]),
                        ("K1_mismatch", ["-K", "1"])):
        validate_row(name, extra)
    validate_row("pcr", ["-M", "2000"], pats=pairs, prog="pcr_match",
                 flags=("-r",))
    validate_row("peptide_6frame", [], pats=peps, prog="peptide_scan",
                 flags=("-T", "A"))
    validate_row("wide_alpha_wc", ["-w"], pats=wpats, corpus=WIDE_CORPUS)

    scan_bps = bench_scan()
    cache = json.load(open(BASELINE_CACHE)) if os.path.exists(
        BASELINE_CACHE) else {}
    ref_bps = cache.get("reference_bases_per_sec")
    if ref_bps is None:
        if _have_ref():
            dt = _ref_seconds([os.path.join(REF, "primer_match"), "-i",
                               CORPUS, "-P", _patfile(PATS, "pats"), "-r",
                               "-c"])
            ref_bps = (CORPUS_BASES / dt) if dt else None
        if ref_bps is not None:
            cache["reference_bases_per_sec"] = ref_bps
            with open(BASELINE_CACHE, "w") as f:
                json.dump(cache, f)

    def row(name, ours_bps, ref):
        matrix[name] = {
            "value": round(ours_bps / 1e6, 2),
            "unit": "Mbases/s",
            "ref": round(ref / 1e6, 2) if ref else None,
            "vs_baseline": round(ours_bps / ref, 2) if ref else 0.0,
        }

    v = bench_k_edit(db, 1, True)
    row("k1_edit", v, ref_anchor(
        "k1_edit", lambda: ref_primer_match(PATS, "pats", ["-k", "1"])))

    v = bench_k_edit(db, 2, True)
    row("k2_edit", v, ref_anchor(
        "k2_edit", lambda: ref_primer_match(PATS, "pats", ["-k", "2"])))

    v = bench_k_edit(db, 1, False)
    row("K1_mismatch", v, ref_anchor(
        "K1_mismatch", lambda: ref_primer_match(PATS, "pats", ["-K", "1"])))

    v, xp = bench_xmers_p50k(db, codes)
    row("xmers_p50k", v, ref_anchor(
        "xmers_p50k",
        lambda: ref_primer_match(xp, "p50k", [])))
    validate_xmers(db, codes, xp)

    v, k1db = bench_xmers_k1(db, codes, xp)

    def _ref_xk1():
        if not _have_ref():
            return None
        make_slice()
        dt = _ref_seconds(
            [os.path.join(REF, "primer_match"), "-i", SLICE, "-P",
             _patfile(xp, "p50k"), "-r", "-c", "-k", "1"],
            min_total=0.0)
        return (len(k1db.codes) / dt) if dt else None

    row("xmers_k1", v, ref_anchor("xmers_k1", _ref_xk1))
    validate_xmers_k1(xp)

    v = bench_pcr(db, pairs)

    def _ref_pcr():
        if not _have_ref("pcr_match"):
            return None
        dt = _ref_seconds(
            [os.path.join(REF, "pcr_match"), "-i", CORPUS, "-P",
             _patfile(pairs, "pcr"), "-r", "-M", "2000"])
        return (CORPUS_BASES / dt) if dt else None

    row("pcr", v, ref_anchor("pcr", _ref_pcr))

    v = bench_peptide(db, tdb, peps)

    def _ref_pep():
        if not _have_ref("peptide_scan"):
            return None
        dt = _ref_seconds(
            [os.path.join(REF, "peptide_scan"), "-i", CORPUS, "-T", "A",
             "-P", _patfile(peps, "peps")])
        return (CORPUS_BASES / dt) if dt else None

    row("peptide_6frame", v, ref_anchor("peptide_6frame", _ref_pep))

    v = bench_wide_wc(wdb, wpats)

    def _ref_wide():
        if not _have_ref():
            return None
        patfile = _patfile(wpats, "wide")
        dt = _ref_seconds(
            [os.path.join(REF, "primer_match"), "-i", WIDE_CORPUS, "-P",
             patfile, "-r", "-w", "-c"])
        return (CORPUS_BASES / dt) if dt else None

    def _row_wide():
        # anchor key versioned: the corpus grew 4 M -> 16 M in round 5,
        # so the cached 4 M anchor must not be reused
        ref = ref_anchor("wide_alpha_wc16", _ref_wide)
        matrix["wide_alpha_wc"] = {
            "value": round(v / 1e6, 2),
            "unit": "Mbases/s",
            "ref": round(ref / 1e6, 2) if ref else None,
            "vs_baseline": round(v / ref, 2) if ref else 0.0,
        }

    _row_wide()

    vs = (scan_bps / ref_bps) if ref_bps else 0.0
    full = {
        "metric": "exact scan throughput (20-pattern primer set, both strands)",
        "value": round(scan_bps / 1e6, 2),
        "unit": "Mbases/s",
        "vs_baseline": round(vs, 2),
        "matrix": matrix,
        "notes": {
            "methodology": "matrix rows = resident-serving posture "
            "(tables/uploads/compiles amortized, overlapped streams); "
            "oneshot_* rows = cold CLI wall, run before this process "
            "opens the device and output-validated, booted via the "
            "shipped site-less `sat` launcher (the launcher floor is "
            f"the measured {round(floor_s, 2)} s `python -S -c pass`; "
            "output asserted identical to a sited `python -m` boot "
            "each run), with SAT_AUTO_ARTIFACTS persistence — the "
            "reference's own production model is "
            "compress_seq-preprocessed input; every row's output is "
            "validated byte-for-byte against the reference binary (or "
            "an independent host algorithm for P=50k) on a corpus "
            "slice before it is reported",
        },
    }
    # Full record (matrix + notes) goes to a FILE; the printed line must
    # stay compact enough to survive the driver's fixed-size tail capture
    # (BENCH_r04.json lost the headline fields to truncation: VERDICT r4
    # item 6).  The compact matrix is {row: [value, vs_baseline]}.
    with open(os.path.join(HERE, "bench_full.json"), "w") as f:
        json.dump(full, f, indent=1)
    print(json.dumps({
        "metric": full["metric"],
        "value": full["value"],
        "unit": full["unit"],
        "vs_baseline": full["vs_baseline"],
        "matrix": {k: [r["value"], r["vs_baseline"]]
                   for k, r in matrix.items()},
        "full": "bench_full.json",
    }))


if __name__ == "__main__":
    main()
