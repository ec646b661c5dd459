"""Fused microhit filter and the device scan pipelines built on it.

The hot loop of every exact / k-mismatch scan (the reference walks an
Aho-Corasick automaton or shift-and bitvectors one char at a time,
``keyword_tree.t:427-486``, ``shift_and.cc:218-254``).  Per text position
``i`` and pattern ``p`` the filter computes the correlation margin

    margin(i, p) = sum_j sum_c [text[i+j] in class c] * W[j, c, p] - thr[p]

and reduces it on the fly: ``max_p margin >= 0`` per 32-position
microblock (``emit="occupancy"``), or per position the hit count and the
top hitting pattern (``emit="pos"``).  Written as plain ``jax.numpy``:
XLA fuses the whole expression — the class compares, the weight selects,
the sum over pattern positions and the reduction over patterns — into
one reduction kernel, so the ``[n, P]`` margins never reach device
memory.  Margins are small integers and every term is int32.

Everything after the filter is ordinary XLA as well: microblock
compaction (:mod:`.compact`), candidate window gather, exact rescore and
hit packing (:func:`scan_hits`), or the pigeonhole seed-extension gate
(:func:`scan_gated`).

EOS / entry-boundary semantics ride in the weights (poison rows),
identical to :func:`..tables.conv_weights`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# class markers >= BITCLS mean "indicator = bit (c - BITCLS) of the
# (recoded) text byte" instead of "text byte == c": the wide-alphabet
# bit-plane modes (ConvScanner._bitplane_mode) recode the resident text
# to base masks or class ids and scan a few bit planes instead of one
# plane per live class.
BITCLS = 256

# positions per filter block: the filter runs as a loop over blocks so
# that an unfused fallback could never hold more than one block's
# [block, P] margins (first choice, not tuned).
FBLOCK = 1 << 22


def filter_weights(tables, k: int, poison_eos: bool, fold: bool = True,
                   bitw=None):
    """(W [Lmax, nc, P] int32, thr [P] int32, classes tuple).

    ``classes[ci]`` names the indicator of weight plane ``ci``: a text
    code, or ``BITCLS + b`` for bit ``b`` of the recoded text.  Only LIVE
    classes (any nonzero weight) get a plane.

    BASE-CLASS FOLD (``fold=True``): one nonnegative class column is
    subtracted from every class and its per-pattern total moves into the
    threshold, so the folded class needs no plane.  For text codes with a
    plane the margin is unchanged; codes with NO plane (EOS, N, dead
    classes) score w(base) >= 0 instead of 0, so the folded filter is a
    SUPERSET (the exact rescore in :func:`scan_hits` rejects the extras).
    With ``fold=False`` margins are exact: margin >= 0 <=> the window is a
    true scan hit (the precondition of the in-filter hit extraction,
    :func:`pos_exact_ok`).

    ``bitw = (wbit [L, NB, P], bitcls[, thr])`` selects the bit-plane
    modes: weights indexed by bit, no fold, optional per-pattern
    thresholds (the class-encode mode's margins peak at the pattern's
    1-bit count, not its length)."""
    from .tables import conv_weights

    bit_thr = None
    if bitw is not None:
        if len(bitw) == 3:
            w, classes, bit_thr = bitw
        else:
            w, classes = bitw
        w = np.asarray(w, np.float32)
        P = w.shape[2]
        fold = False
    else:
        w = conv_weights(tables, k, poison_eos).astype(np.float32)
        _Lmax, alpha, P = w.shape
        classes = tuple(c for c in range(alpha) if np.any(w[:, c, :]))
        if not classes:
            classes = (0,)
    base_cls = None if not fold else next(
        (c for c in classes if np.all(w[:, c, :] >= 0)), None)
    if base_cls is not None and len(classes) > 1:
        base_col = w[:, base_cls, :].copy()  # [L, P]
        w = w - base_col[:, None, :]
        base_tot = base_col.sum(axis=0)  # [P]
        classes = tuple(c for c in classes if c != base_cls)
    else:
        base_tot = np.zeros((P,), np.float32)
    wsel = w if bitw is not None else np.stack(
        [w[:, c, :] for c in classes], axis=1)  # [L, nc, P]
    if bit_thr is not None:
        thr = np.asarray(bit_thr, np.int64)
    else:
        thr = np.round(
            tables.lengths.astype(np.float64) - int(k) - base_tot
        ).astype(np.int64)
    return (np.rint(wsel).astype(np.int32), thr.astype(np.int32),
            tuple(int(c) for c in classes))


def _plane(c, cls: int):
    """Indicator of class marker ``cls`` over int32 text codes."""
    if cls >= BITCLS:
        return ((c >> (cls - BITCLS)) & 1) > 0
    return c == cls


def _margins(blk, W, thr, classes: tuple, B: int):
    """[B, P] int32 margins of the B window starts of ``blk`` (which
    carries the Lmax - 1 right halo)."""
    Lmax = W.shape[0]
    acc = -thr[None, :]
    for j in range(Lmax):
        c = blk[j : j + B].astype(jnp.int32)[:, None]
        for ci, cls in enumerate(classes):
            acc = acc + jnp.where(_plane(c, cls), W[j, ci][None, :], 0)
    return acc


def microhits(codes, W, thr, *, classes: tuple, MB: int = 32,
              pad: int = 0, emit: str = "occupancy"):
    """The microhit filter over a whole flat code array.

    codes: [n] uint8 device array; W, thr, classes from
    :func:`filter_weights`; ``pad`` fills positions past the end.

    ``emit="occupancy"``: [N // MB] bool, microblock m holds a window
    start in [MB*m, MB*(m+1)) whose margin is >= 0 for some pattern.
    ``emit="pos"``: [N] int32 per-position words ``(top << 8) | min(cnt,
    255)`` (cnt = patterns with margin >= 0, top = the largest such
    pattern index; -256 where none) — exact hit extraction, valid only
    under :func:`pos_exact_ok` weights.  N >= n is n rounded up to the
    filter block; entries past n cover pad positions."""
    Lmax, _nc, P = W.shape
    n = codes.shape[0]
    B = min(FBLOCK, -(-max(n, 1) // MB) * MB)
    nb = -(-max(n, 1) // B)
    ext = jnp.concatenate([
        codes.astype(jnp.uint8),
        jnp.full((nb * B + Lmax - 1 - n,), pad, jnp.uint8)])

    def one(b):
        blk = jax.lax.dynamic_slice(ext, (b * B,), (B + Lmax - 1,))
        m = _margins(blk, W, thr, classes, B)
        if emit == "occupancy":
            return m.reshape(B // MB, MB * P).max(axis=1) >= 0
        hit = m >= 0
        cnt = jnp.sum(hit, axis=1, dtype=jnp.int32)
        top = jnp.max(jnp.where(
            hit, jax.lax.broadcasted_iota(jnp.int32, (B, P), 1), -1), axis=1)
        return jnp.where(cnt > 0, (top << 8) | jnp.minimum(cnt, 255),
                         jnp.int32(-256))

    if nb == 1:
        return one(0)
    return jax.lax.map(one, jnp.arange(nb, dtype=jnp.int32)).reshape(-1)


def pos_exact_ok(tables, k: int) -> bool:
    """True when the ``emit="pos"`` extraction is EXACT for this scan
    config: margins must equal (score - threshold) of the true accept
    test.  Requires k == 0 (the gated pipeline's seed scans are always
    exact) and no empty pattern.  Unfolded weights from
    :func:`..tables.conv_weights` are 0/1(+poison) by construction, so
    margin >= 0 <=> every window position accepted <=> true hit; EOS
    (poison or plain-zero) sinks straddling windows below threshold
    either way."""
    return bool(k == 0 and int(tables.lengths.min(initial=1)) >= 1)


def _rescore(codes, mb_idx, nmb: int, wconv, *, alpha: int, Lmax: int,
             eos_code: int, MB: int):
    """Exact window scores [cap_mb * MB, P] float32 of the candidate
    microblocks ``mb_idx`` and their window starts [cap_mb * MB]."""
    n = codes.shape[0]
    cap_mb = mb_idx.shape[0]
    P = wconv.shape[2]
    win_len = MB + Lmax - 1
    # pad with EOS (callers pass a real code >= 0) so windows crossing
    # the array end behave exactly like the XLA block path (poison
    # weights reject them in k>0 mode)
    eos_fill = jnp.full(max(nmb * MB + win_len - n, 0), max(eos_code, 0),
                        jnp.uint8)
    padded = jnp.concatenate([codes, eos_fill])
    starts = jnp.minimum(mb_idx, nmb - 1).astype(jnp.int32) * MB
    wins = padded[
        starts[:, None]
        + jax.lax.broadcasted_iota(jnp.int32, (1, win_len), 1)
    ]  # [cap_mb, win_len]
    sub_idx = (
        jax.lax.broadcasted_iota(jnp.int32, (MB, Lmax), 0)
        + jax.lax.broadcasted_iota(jnp.int32, (MB, Lmax), 1)
    )
    sub = wins[:, sub_idx]  # [cap_mb, MB, Lmax]
    # one im2col matmul; bf16 operands hold the small integer weights
    # exactly and the float32 accumulation keeps every sum exact
    im2col = jax.nn.one_hot(sub, alpha, dtype=jnp.bfloat16).reshape(
        cap_mb * MB, Lmax * alpha)
    scores = jnp.dot(im2col, wconv.reshape(Lmax * alpha, P),
                     preferred_element_type=jnp.float32)
    pstart = (starts[:, None]
              + jax.lax.broadcasted_iota(jnp.int32, (1, MB), 1)).reshape(-1)
    return scores, pstart


@functools.partial(
    jax.jit,
    static_argnames=("classes", "alpha", "Lmax", "eos_code", "MB", "cap_mb",
                     "hit_cap"),
)
def scan_hits(codes, W, thr, wconv, thresholds, lengths, *,
              classes: tuple, alpha: int, Lmax: int, eos_code: int = -1,
              MB: int = 32, cap_mb: int = 1024, hit_cap: int = 4096):
    """The full scan pipeline in ONE device call: microhit filter ->
    microblock compaction -> candidate window gather -> exact rescore ->
    hit index extraction.  A single host round-trip per scan (the scan
    loop seam of the reference, primer_match.cc:1114-1268, costs one
    cursor save per batch; here it costs one transfer per *database*).

    codes: [n] uint8; wconv: [Lmax, alpha, P] bf16 (conv_weights layout);
    thresholds, lengths: [P] f32 / int32.
    Returns ONE packed int32 array: (mb_count, hit_count, mb_idx...,
    hits...) — a hit flat-indexes [cap_mb, MB, P] row-major; overflow
    when mb_count > cap_mb or hit_count > hit_cap (caller retries with
    bigger caps).  When the flat index space fits 24 bits the mismatch
    count rides in the hit word's high byte (``mism << 24 | idx``, row
    length 2 + cap_mb + hit_cap); otherwise mismatches follow as a
    separate section (row length 2 + cap_mb + 2*hit_cap)."""
    from .compact import compact_mask

    codes = codes.astype(jnp.uint8)  # alphabet codes < 256, end-to-end
    P = wconv.shape[2]
    mh = microhits(codes, W, thr, classes=classes, MB=MB,
                   pad=max(eos_code, 0))
    nmb = mh.shape[0]
    mb_count, mb_idx = compact_mask(mh, cap_mb)
    scores, _ = _rescore(codes, mb_idx, nmb, wconv, alpha=alpha, Lmax=Lmax,
                         eos_code=eos_code, MB=MB)
    valid = jnp.repeat(mb_idx < nmb, MB)[:, None]
    hit = (scores >= thresholds[None, :]) & valid
    hit_count, hit_idx = compact_mask(hit.reshape(-1), hit_cap)
    # mismatch counts gathered per hit only (never materialized densely)
    sflat = jnp.concatenate([scores.reshape(-1), jnp.zeros((1,), jnp.float32)])
    mism = jnp.clip(
        lengths[hit_idx % P].astype(jnp.int32)
        - sflat[hit_idx].astype(jnp.int32), 0, 127)
    if cap_mb * MB * P < (1 << 24):
        hits = (mism << 24) | hit_idx.astype(jnp.int32)
        return jnp.concatenate(
            [mb_count[None], hit_count[None], mb_idx, hits])
    return jnp.concatenate([
        mb_count[None], hit_count[None], mb_idx,
        hit_idx.astype(jnp.int32), mism,
    ])


@functools.partial(
    jax.jit,
    static_argnames=(
        "classes", "alpha", "Lmax", "eos_code", "MB", "cap_mb", "hit_cap",
        "multi_cap", "surv_cap", "Lg", "kk", "band", "indels", "exact_pos",
    ),
)
def scan_gated(codes, W, thr, wconv, thresholds, lengths,
               gaccept, gglen, ggdir, *,
               classes: tuple, alpha: int, Lmax: int,
               eos_code: int = -1, MB: int = 32,
               cap_mb: int = 1024, hit_cap: int = 4096,
               multi_cap: int = 256, surv_cap: int = 512,
               Lg: int = 16, kk: int = 1, band: int = 1,
               indels: bool = True, exact_pos: bool = False):
    """The k>0 pigeonhole pipeline in ONE device call: microhit seed
    filter -> compaction -> per-position top seed -> SEED-EXTENSION GATE
    (:func:`..gate._gate_ok`, a vectorized banded DP superset of the true
    extension) -> survivor compaction.  The host fetches only the (rare)
    gate survivors and re-extends them with the exact native DP — the
    find/verify alternation of exact_halves.cc:120-197 with the seed scan
    AND the almost-always-failing extensions kept on device.

    With ``exact_pos`` (:func:`pos_exact_ok` configs, unfolded ``W``)
    the filter's per-position words ARE the seed hits; otherwise an exact
    rescore of the candidate microblocks produces them.  Positions where
    SEVERAL seeds hit (rare: prefix-nested or duplicate seeds) go to a
    tiny escape list for the host to rescan exactly.

    Returns ONE packed int32 row:
        [mb_count, hit_count, multi_count, surv_count,
         surv_anchor x surv_cap, surv_sid x surv_cap,
         multi_start x multi_cap]
    (anchor = seed-hit end position; sid = 0-based seed index; the
    escape list holds window START positions).  Overflow when any count
    exceeds its cap — caller retries with bigger caps; correctness never
    depends on capacity."""
    from .compact import compact_mask
    from .gate import _gate_ok

    codes = codes.astype(jnp.uint8)
    n = codes.shape[0]
    P = wconv.shape[2]
    pad = max(eos_code, 0)
    if exact_pos:
        word = microhits(codes, W, thr, classes=classes, MB=MB, pad=pad,
                         emit="pos")
        nmb = word.shape[0] // MB
        w2 = word.reshape(nmb, MB)
        mb0 = jax.lax.broadcasted_iota(jnp.int32, (nmb,), 0) * MB
        mb_count, mb_idx = compact_mask(
            (w2.max(axis=1) >= 0) & (mb0 < n), cap_mb)
        mbs = jnp.minimum(mb_idx, nmb - 1)
        wflat = w2[mbs].reshape(-1)
        pstart = ((mbs * MB)[:, None]
                  + jax.lax.broadcasted_iota(jnp.int32, (1, MB), 1)
                  ).reshape(-1)
        pvalid = jnp.repeat(mb_idx < nmb, MB) & (pstart < n)
        cnt = jnp.where(pvalid & (wflat >= 0), wflat & 255, 0)
        top_pid = jnp.where(cnt > 0, wflat >> 8, -1)
        # windows overrunning the array end read pad codes; escape every
        # such hit position to the exact host rescan (<= Lmax - 1
        # positions; survivors there are dropped by the caller in favor
        # of the rescan, conv_scan.scan_gated)
        multi_m = (cnt > 1) | ((cnt > 0) & (pstart > n - Lmax))
    else:
        mh = microhits(codes, W, thr, classes=classes, MB=MB, pad=pad)
        nmb = mh.shape[0]
        mb_count, mb_idx = compact_mask(mh, cap_mb)
        scores, pstart = _rescore(codes, mb_idx, nmb, wconv, alpha=alpha,
                                  Lmax=Lmax, eos_code=eos_code, MB=MB)
        hitm = scores >= thresholds[None, :]
        # per-position reduction: hit count + top (max-id) hitting seed
        cnt = jnp.sum(hitm, axis=1, dtype=jnp.int32)  # [cap_mb*MB]
        piota = jax.lax.broadcasted_iota(jnp.int32, hitm.shape, 1)
        top_pid = jnp.max(jnp.where(hitm, piota, -1), axis=1)
        pvalid = (jnp.repeat(mb_idx < nmb, MB)) & (pstart < n)
        cnt = jnp.where(pvalid, cnt, 0)
        multi_m = cnt > 1

    hit_count, sel = compact_mask(cnt > 0, hit_cap)
    svalid = sel < cap_mb * MB
    sidx = jnp.minimum(sel, cap_mb * MB - 1)
    cstart = pstart[sidx]
    cpid = jnp.clip(top_pid[sidx], 0, P - 1)
    anchors = cstart + lengths[cpid].astype(jnp.int32)

    # escape list: positions with >1 hitting seed (host rescans those
    # windows exactly and resolves ALL their seeds itself)
    multi_count, msel = compact_mask(multi_m, multi_cap)
    mvalid = msel < cap_mb * MB
    multi_start = jnp.where(
        mvalid, pstart[jnp.minimum(msel, cap_mb * MB - 1)], -1)

    ok = _gate_ok.__wrapped__(
        codes, anchors, cpid, gaccept, gglen, ggdir,
        Lg=Lg, k=kk, band=band, indels=indels, n=int(n),
    )
    surv_count, ssel = compact_mask(ok & svalid, surv_cap)
    qvalid = ssel < hit_cap
    qidx = jnp.minimum(ssel, hit_cap - 1)
    surv_anchor = jnp.where(qvalid, anchors[qidx], -1)
    surv_sid = jnp.where(qvalid, cpid[qidx], -1)
    return jnp.concatenate([
        mb_count[None], hit_count[None], multi_count[None],
        surv_count[None],
        surv_anchor.astype(jnp.int32), surv_sid.astype(jnp.int32),
        multi_start.astype(jnp.int32),
    ])
