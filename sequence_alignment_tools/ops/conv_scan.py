"""Correlation scan: exact and k-mismatch multi-pattern matching.

The device replacement for the reference's Aho-Corasick keyword tree and
shift-and scan loops (``keyword_tree.t:427-486``, ``shift_and.cc:218-254``):
multi-pattern matching *without indels* is a one-hot correlation

    score(i, p) = sum_j W[j, text[i+j], p]

``score == L_p`` is an exact (or exact-with-wildcards) match ending at
``i + L_p``; ``score >= L_p - k`` is a k-mismatch candidate (EOS positions
carry a poison weight so no window straddles an entry boundary).

Routes, chosen per scan by :class:`ConvScanner`: the native host machines
(shift-and, radix / mer-hash census) for small or dense-seed scans, the
fused microhit pipeline (:mod:`.microhit`) on the GPU, and the XLA block
scan (:func:`_conv_scan_block`) everywhere else.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..utils import lazyjax
from ..utils.lazyjax import LazyModule, lazy_jit

# Deferred: host-routed one-shot runs (native shift-and / census) must not
# pay the jax import.  First device-path attribute access swaps in the
# real modules.
jax = LazyModule("jax", "jax", globals())
jnp = LazyModule("jax.numpy", "jnp", globals())


@lazy_jit(static_argnames=("cap_mb", "hit_cap", "gcap", "long_form"))
def _pack_group(stacked, *, cap_mb: int, hit_cap: int, gcap: int,
                long_form: bool):
    """Compact a stacked group of packed scan results to live entries.

    ``stacked``: [g, row] int32 — g packed rows from
    :func:`.microhit.scan_hits` sharing one (cap_mb, hit_cap) layout.
    Each row is almost entirely capacity padding (true counts are tiny on
    non-degenerate inputs), so the group is packed into ONE small row
    before the device-to-host copy:

        [g true mb_counts][g true hit_counts]
        [gcap mb entries][gcap hit entries]([gcap mism entries])

    where the entry sections are each row's live prefix concatenated in
    row order (clamped to the caps).  The host re-segments with a cumsum
    of the clamped counts; if the clamped totals exceed ``gcap`` the host
    falls back to fetching the full stacked rows (rare — it also grows
    ``gcap`` for the next group).  Pure XLA: a cumsum + searchsorted
    segmented gather, no data-dependent shapes.
    """

    g = stacked.shape[0]
    mbc_true = stacked[:, 0]
    hc_true = stacked[:, 1]
    mbc = jnp.minimum(mbc_true, cap_mb)
    hc = jnp.minimum(hc_true, hit_cap)

    def seg_gather(counts, section):
        width = section.shape[1]
        cum = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)])
        pos = jax.lax.broadcasted_iota(jnp.int32, (gcap,), 0)
        row = jnp.clip(
            jnp.searchsorted(cum, pos, side="right") - 1, 0, g - 1)
        off = pos - cum[row]
        valid = pos < cum[g]
        src = row * width + jnp.minimum(off, width - 1)
        out = section.reshape(-1)[jnp.where(valid, src, 0)]
        return jnp.where(valid, out, 0)

    mb_sec = stacked[:, 2 : 2 + cap_mb]
    hit_sec = stacked[:, 2 + cap_mb : 2 + cap_mb + hit_cap]
    parts = [mbc_true, hc_true, seg_gather(mbc, mb_sec),
             seg_gather(hc, hit_sec)]
    if long_form:
        mism_sec = stacked[:, 2 + cap_mb + hit_cap : 2 + cap_mb + 2 * hit_cap]
        parts.append(seg_gather(hc, mism_sec))
    return jnp.concatenate(parts)


@functools.lru_cache(maxsize=None)
def _shared_scan_jit(classes, alpha, Lmax, eos_code, MB, cap_mb, hit_cap):
    """One jitted fused-scan entry per static config, SHARED across
    scanner instances: a per-instance ``jax.jit`` wrapper would re-trace
    (and on a cold persistent cache, re-compile) for every scanner a CLI
    run builds."""
    from .microhit import scan_hits

    @jax.jit
    def jfn(codes_dev, W, thr, weights, thresholds, lengths):
        return scan_hits(
            codes_dev, W, thr, weights, thresholds, lengths,
            classes=classes, alpha=alpha, Lmax=Lmax, eos_code=eos_code,
            MB=MB, cap_mb=cap_mb, hit_cap=hit_cap,
        )

    return jfn


_DEV_CACHE: dict = {}


def _device_form(codes):
    """uint8 device copy of a host code array, cached ACROSS scanner
    instances by host-array identity: engines rebuild scanners per run,
    and a resident database must not re-pay the host->device transfer.
    uint8 because codes < alpha <= 255 and int32 would quadruple the
    upload; kernels widen on device.  Entries drop with the host array
    (weakref finalizer)."""
    import weakref

    ent = _DEV_CACHE.get(id(codes))
    if ent is not None and ent[0]() is codes:
        return ent[1]
    dev = jnp.asarray(np.asarray(codes, np.uint8))
    ref = weakref.ref(codes)
    weakref.finalize(codes, _DEV_CACHE.pop, id(codes), None)
    _DEV_CACHE[id(codes)] = (ref, dev)
    return dev


_BIT_CACHE: dict = {}
_bit_recode_jit = None



def _bit_form(codes_dev, lut_dev):
    """Mask-recoded device text for the bit-plane mode (uint8 gather
    through the scanner's 256-entry code->base-mask LUT), cached across
    scanner instances by device-array identity — one-time preprocessing
    per resident database."""
    import weakref

    global _bit_recode_jit
    key = (id(codes_dev), id(lut_dev))
    ent = _BIT_CACHE.get(key)
    # identity must be verified for BOTH keys: a new scanner's lut can
    # land on a dead lut's recycled id while the resident codes_dev
    # stays alive, and the stale entry would hand back text recoded
    # with the OLD class ids (the entry holds the lut strongly, so a
    # simple `is` check suffices)
    if ent is not None and ent[0]() is codes_dev and ent[2] is lut_dev:
        return ent[1]
    if _bit_recode_jit is None:
        _bit_recode_jit = jax.jit(
            lambda c, lut: lut[c.astype(jnp.int32)])
    dev = _bit_recode_jit(codes_dev, lut_dev)
    ref = weakref.ref(codes_dev)
    weakref.finalize(codes_dev, _BIT_CACHE.pop, key, None)
    _BIT_CACHE[key] = (ref, dev, lut_dev)
    return dev



@functools.lru_cache(maxsize=None)
def _shared_gated_jit(classes, alpha, Lmax, eos_code, MB, cap_mb,
                      hit_cap, multi_cap, surv_cap, Lg, kk, band, indels,
                      exact_pos):
    """One jitted gated-scan entry per static config, shared across
    scanner instances (see :func:`_shared_scan_jit`)."""
    from .microhit import scan_gated

    @jax.jit
    def jfn(codes_dev, W, thr, weights, thresholds, lengths,
            gaccept, gglen, ggdir):
        return scan_gated(
            codes_dev, W, thr, weights, thresholds, lengths,
            gaccept, gglen, ggdir,
            classes=classes, alpha=alpha, Lmax=Lmax, eos_code=eos_code,
            MB=MB, cap_mb=cap_mb, hit_cap=hit_cap,
            multi_cap=multi_cap, surv_cap=surv_cap, Lg=Lg, kk=kk,
            band=band, indels=indels, exact_pos=exact_pos,
        )

    return jfn


@lazy_jit(static_argnames=("alpha", "cap"))
def _conv_scan_block(codes, weights, thresholds, lengths, alpha, cap):
    """One text block.

    codes: [B + Lmax - 1] int32 (right halo of Lmax-1, EOS-padded)
    weights: [Lmax, alpha, P] bf16; thresholds/lengths: [P] f32/int32
    Returns ONE packed int32 array [1 + 2*cap]: (count, flat_idx...,
    mism...) where flat_idx indexes the [B, P] (window-start, pattern)
    grid row-major; mism = L_p - score.  Packed so one device-to-host
    copy returns it.

    The correlation is evaluated as Lmax shifted [B, A] @ [A, P] matmuls
    rather than one huge-spatial-dim conv, which XLA compiles far
    better at this shape.
    """
    Lmax = weights.shape[0]
    B = codes.shape[0] - (Lmax - 1)
    codes = codes.astype(jnp.int32)  # shipped uint8 (4x fewer bytes)
    onehot = jax.nn.one_hot(codes, alpha, dtype=jnp.bfloat16)  # [B+Lmax-1, A]

    def step(j, acc):
        window = jax.lax.dynamic_slice_in_dim(onehot, j, B, axis=0)  # [B, A]
        return acc + jnp.dot(
            window, weights[j], preferred_element_type=jnp.float32
        )

    out = jax.lax.fori_loop(
        0, Lmax, step, jnp.zeros((B, weights.shape[2]), jnp.float32)
    )  # [B, P]
    from .compact import compact_mask

    mism = lengths[None, :].astype(jnp.float32) - out
    hit = out >= thresholds[None, :]
    count, idx = compact_mask(hit.reshape(-1), cap)
    m = jnp.concatenate([mism.reshape(-1), jnp.zeros((1,), jnp.float32)])
    return jnp.concatenate(
        [count[None], idx.astype(jnp.int32), m[idx].astype(jnp.int32)]
    )


class ConvScanner:
    """Block-streaming exact / k-mismatch scanner over a flat code array.

    Yields candidates as (end_position, pattern_index_0based, mismatches),
    globally ordered by (window_start, pattern).
    """

    def __init__(self, tables, k: int = 0, poison_eos: bool | None = None,
                 block: int = 1 << 19, cap: int = 1 << 16,
                 use_fused: bool | None = None):
        self.tables = tables
        self.k = k
        if poison_eos is None:
            poison_eos = k > 0
        self.poison_eos = poison_eos
        self.block = block
        self.cap = cap
        # LAZY device state: constructing a scanner must not initialize
        # the jax backend (a one-shot CLI run that the host machines
        # serve never needs it)
        self._use_fused_c = use_fused
        self._wtl_c = None
        # tests: take the fused pipeline on any backend and at any size,
        # bypassing the host machines and the small-input cutoff
        self.force_device = False
        self._filter_wt = None
        self._dispatch_cache = {}

    # the fused filter unrolls one term per (pattern position, class)
    # into a single XLA fusion; longer patterns take the block scan,
    # whose cost does not grow with the unrolled expression
    _FUSED_LMAX = 128

    @property
    def use_fused(self):
        if self._use_fused_c is not None:
            return self._use_fused_c
        if self.force_device:
            return True
        # the fused pipeline is the GPU route (pattern count is
        # unlimited: sets past _PBLOCK scan as a pattern-blocked outer
        # loop); the CPU takes the host machines and the XLA block scan
        self._use_fused_c = (lazyjax.on_gpu()
                             and self.tables.Lmax <= self._FUSED_LMAX)
        return self._use_fused_c

    @use_fused.setter
    def use_fused(self, v):
        self._use_fused_c = v


    def _wtl(self):
        """(weights, thresholds, lengths) device arrays, built on first
        device-path use."""
        if self._wtl_c is None:
            from .tables import conv_weights

            t = self.tables
            self._wtl_c = (
                jnp.asarray(conv_weights(t, self.k, self.poison_eos)),
                jnp.asarray(t.lengths.astype(np.float32) - float(self.k)),
                jnp.asarray(t.lengths),
            )
        return self._wtl_c

    @property
    def weights(self):
        return self._wtl()[0]

    @property
    def thresholds(self):
        return self._wtl()[1]

    @property
    def lengths_dev(self):
        return self._wtl()[2]

    # -- route announcements (VERDICT r2 item 10) ----------------------------

    _routes_done = None

    def _route(self, msg: str) -> None:
        """Name the kernel route actually taken, once per scanner, as a
        reference-style '-v' strategy line (select.cc announcement
        spirit) — so degraded fallbacks are visible.  'Route:' lines
        are framework-native (the reference has none); parity harnesses
        filter them like Progress lines.  Verbose mode (progress
        reporter attached) or SAT_ROUTE_VERBOSE=1 enables them."""
        import os

        if self.progress is None and not os.environ.get(
                "SAT_ROUTE_VERBOSE"):
            return
        if self._routes_done is None:
            self._routes_done = set()
        if msg in self._routes_done:
            return
        self._routes_done.add(msg)
        from ..utils.log import timestamp

        timestamp("Route: " + msg)

    # -- multi-device routing -------------------------------------------------

    # a jax.sharding.Mesh attached by the model layer (parallel.shard.
    # auto_mesh: multi-GPU hosts auto-shard, tests opt in with SAT_MESH=N
    # on the virtual CPU mesh); scans route through the sharded fused
    # pipeline
    mesh = None

    def _sharded_capable(self) -> bool:
        return (self.mesh is not None
                and self.mesh.devices.size > 1
                and self.tables.P <= self._PBLOCK
                and self.tables.Lmax <= self._FUSED_LMAX)

    # -- fused microhit filter + microblock rescore --------------------------

    _MB = 32

    _bitplane_cc = False  # False = uncomputed; None = ineligible

    def _bitplane_mode(self):
        """IUPAC bit-plane mode for wide-alphabet EXACT scans: when the
        accept relation factors as "4-bit base-set intersection
        non-empty" (the -w IUPAC semantics, shift_and.cc:108-117), the
        resident text is recoded to 4-bit base MASKS and the microhit
        filter reads 4 BIT planes (``(text >> b) & 1``) instead of one
        plane per live class (wide alphabets have ~14).  The bit-plane margin counts
        ``sum_j |text_set_j ∩ pattern_set_j|``, which is >= L for every
        true hit (each true position intersects), so the filter is a
        SUPERSET of the class form — the exact in-pipeline rescore
        (reindexed over mask values, exactness verified structurally
        below) rejects the extras.  Returns None when ineligible (k>0,
        poison, non-factorable accepts, few classes, mesh) — the class
        planes are used unchanged.  The embedding is derived from the
        accept tables themselves (minimal accept sets = base stars) and
        VERIFIED against every (pattern, position, code) triple, so a
        wrong guess degrades to None, never to wrong output."""
        if self.mesh is not None and self.mesh.devices.size > 1:
            # the single-chip dispatch never runs bit modes under a
            # mesh; the SHARDED pipeline consults _bitmode_nomesh and
            # recodes before sharding (parallel.shard)
            return None
        return self._bitmode_nomesh()

    def _bitmode_nomesh(self):
        """The bit-plane mode ignoring the mesh attachment — shared by
        the single-device dispatch and the sharded pipeline (which
        applies the LUT recode host-side before sharding)."""
        if self._bitplane_cc is not False:
            return self._bitplane_cc
        self._bitplane_cc = None
        cc = self._bitplane_iupac()
        if cc is None:
            cc = self._exact_encode_cc()
        self._bitplane_cc = cc
        return cc

    def _bitplane_iupac(self):
        t = self.tables
        if (self.k != 0 or self.poison_eos or t.alpha > 64
                or os.environ.get("SAT_BITPLANES", "1") != "1"):
            return None
        if t.code_chars is None:
            return None
        acc = np.asarray(t.match)  # [P, Lmax, alpha] bool
        P, Lmax, alpha = acc.shape
        if not P:
            return None
        live = [c for c in range(alpha) if acc[:, :, c].any()]
        if len(live) < 6:
            return None  # the class planes are already cheap
        # code -> 4-bit DNA base set (A=1, C=2, G=4, T=8), from the
        # IUPAC CONTAINS table (U counts as T); 0 for non-IUPAC chars
        from ..utils.iupac import CONTAINS

        bit_of = {"A": 1, "C": 2, "G": 4, "T": 8, "U": 8}
        tcb = np.zeros(alpha, np.uint8)
        for c in range(alpha):
            for ch in CONTAINS.get(chr(t.code_chars[c]).upper(), ""):
                tcb[c] |= bit_of.get(ch, 0)
        # filter mask per (pattern, position): the OR of the accepted
        # PURE-BASE codes' bits — for the IUPAC compatible relation this
        # reconstructs the pattern char's own base set (every base of
        # set_p is an accepted singleton), which every accepted code
        # intersects; positions where that is unsound (table quirks,
        # exact-match-on-ambiguity-code accepts) widen to the union of
        # all accepted codes' sets, and the usefulness guard below
        # declines if the masks degenerate toward all-bits
        acc_any = acc.any(axis=2)  # [P, Lmax]
        single = np.zeros((P, Lmax), np.uint8)
        for c in range(alpha):
            if tcb[c] in (1, 2, 4, 8):
                single |= np.where(acc[:, :, c], tcb[c], 0).astype(
                    np.uint8)
        fpb = single
        inter = (tcb[None, None, :] & fpb[:, :, None]) != 0
        bad_pos = np.argwhere((acc & ~inter).any(axis=2))
        if len(bad_pos) > 100_000:
            return None
        for p, j in bad_pos:
            # a quirk accept outside the char's own base set (e.g. the
            # reference's COMPATIBLE["T"] listing V, iupac.py:18-37):
            # widen MINIMALLY — greedy bit cover of the violating codes
            # (the full accepted-union measured fpb = all-bits at every
            # T position, which collapsed the filter's selectivity)
            cur = int(fpb[p, j])
            viol = [c for c in range(alpha)
                    if acc[p, j, c] and not (tcb[c] & cur)]
            while viol:
                cnt = [sum(1 for c in viol if (tcb[c] >> b) & 1)
                       for b in range(4)]
                b = int(np.argmax(cnt))
                if cnt[b] == 0:
                    return None  # an accepted code with mask 0
                cur |= 1 << b
                viol = [c for c in viol if not (tcb[c] & cur)]
            fpb[p, j] = cur
        # SOUNDNESS check: every accepted code must intersect the filter
        # mask (the bit filter is then a superset of the true accept;
        # the exact rescore below rejects the extras)
        inter = (tcb[None, None, :] & fpb[:, :, None]) != 0
        if (acc & ~inter).any():
            return None
        # mask-injectivity for the exact rescore reindex: live codes
        # sharing a base mask must have identical accept columns
        for i, c1 in enumerate(live):
            if tcb[c1] == 0:
                return None
            for c2 in live[i + 1 :]:
                if tcb[c1] == tcb[c2] and not (
                        acc[:, :, c1] == acc[:, :, c2]).all():
                    return None
        # usefulness guard: wide filter masks admit most of the text and
        # shift all the work to the rescore — decline degenerate sets
        if float(np.unpackbits(fpb[acc_any]).sum()) > \
                2.5 * float(acc_any.sum()):
            return None
        from .microhit import BITCLS, filter_weights

        bitcls = tuple(BITCLS + b for b in range(4)
                       if ((fpb >> b) & 1).any())
        if not bitcls or len(bitcls) + 1 >= len(live):
            return None  # no pass-count win over the folded class form
        wbit = np.zeros((Lmax, len(bitcls), P), np.float32)
        for ci, c in enumerate(bitcls):
            wbit[:, ci, :] = ((fpb >> (c - BITCLS)) & 1).T
        W, thr, classes = filter_weights(t, 0, False,
                                         bitw=(wbit, bitcls))
        # exact rescore weights, REINDEXED by mask value: the recode is
        # injective on live codes (checked above), so this is the true
        # accept table in mask space
        wconv16 = np.zeros((Lmax, 16, P), np.float32)
        for c in live:
            np.maximum(wconv16[:, tcb[c], :],
                       acc[:, :, c].T.astype(np.float32),
                       out=wconv16[:, tcb[c], :])
        # DEAD codes (accepted by nothing — EOS, stray chars, quirk
        # exclusions like text-U vs a K pattern) recode to mask 0, which
        # no wconv16 column accepts: recoding them to their CONTAINS
        # mask would ALIAS any live code sharing that mask (U vs T both
        # map to 8) and the mask-space rescore — injective only on live
        # codes — would accept them where the reference rejects.
        lut = np.zeros(256, np.uint8)
        live_mask = np.zeros(alpha, bool)
        live_mask[live] = True
        lut[:alpha] = np.where(live_mask, tcb, 0)
        self._route(
            "wide-alphabet BIT-PLANE filter (%d live classes -> %d bit "
            "planes + exact rescore)" % (len(live), len(bitcls)))
        return {
            "W": jnp.asarray(W), "thr": jnp.asarray(thr),
            "classes": classes,
            "wconv": jnp.asarray(wconv16),
            "lut": jnp.asarray(lut),
            "alpha_r": 16, "eos_r": 0,
        }

    def _exact_encode_cc(self):
        """Exact class-ENCODE bit planes for wide-alphabet EXACT scans
        whose accept sets don't factor as IUPAC base sets — the peptide
        regime (``peptide_scan`` exact AA matching over ~20 live
        classes, peptide_scan.cc via primer_match.cc:1114's shared scan
        stack).  Live codes are grouped into equivalence classes by
        accept-COLUMN equality; when every accept set is exactly one
        such class (true for any exact matcher, incl. case folding),
        each class gets a B-bit id (B = ceil(log2(ncls + 1)); one spare
        id is the DEAD id for never-accepted codes and EOS) and the
        filter scans B bit planes of the recoded text with +/-1 weights:
        margin = #(pattern-bit 1, text-bit 1) - #(pattern-bit 0,
        text-bit 1) peaks at the pattern's total 1-bit count npos_p,
        and ANY wrong char at any position loses at least 1 (its id
        differs in >= 1 bit) — so margin >= npos_p is an EXACT filter
        (EOS-straddling windows are rejected structurally: the dead id
        differs from every live id).  The in-pipeline rescore still
        runs (same machinery as the IUPAC mode, reindexed over class
        ids) and is cheap because the candidate set is just the true
        hits.  ~20 class planes become 5 bit planes."""
        t = self.tables
        if (self.k != 0 or self.poison_eos
                or os.environ.get("SAT_BITPLANES", "1") != "1"
                or os.environ.get("SAT_EXACTCODE", "1") != "1"):
            return None
        acc = np.asarray(t.match)  # [P, Lmax, alpha] bool
        P, Lmax, alpha = acc.shape
        if not P:
            return None
        live = [c for c in range(alpha) if acc[:, :, c].any()]
        if not live:
            return None
        if len(live) < 6:
            return None  # the folded class planes are already cheap
        # equivalence classes of live codes by accept-column equality
        col_of = {}
        clsid = np.full(alpha, -1, np.int64)
        for c in live:
            key = acc[:, :, c].tobytes()
            if key not in col_of:
                col_of[key] = len(col_of) + 1  # ids 1..; 0 = dead
            clsid[c] = col_of[key]
        ncls = len(col_of)
        nbits = max(1, int(np.ceil(np.log2(ncls + 1))))
        if nbits > 5 or nbits + 1 >= len(live):
            return None  # no pass-count win (or > 32 ids)
        dead = 0  # id for never-accepted codes and EOS (no bits set,
        # loses every pattern-bit-1 plane)
        # every accept set must be exactly ONE equivalence class: all
        # accepted codes at (p, j) share a column (then margin
        # exactness holds per char) — true for exact matchers
        cid_acc = np.where(acc, clsid[None, None, :], -1)
        acc_any = acc.any(axis=2)  # [P, Lmax]
        pid = cid_acc.max(axis=2)  # the accept class id per (p, j)
        mixed = acc & (cid_acc != pid[:, :, None]) & (cid_acc >= 0)
        if mixed.any():
            return None
        if (clsid[live] < 0).any():
            return None
        # +/-1 bit-plane weights and the npos thresholds
        bits = ((pid[:, :, None] >> np.arange(nbits)[None, None, :])
                & 1)  # [P, Lmax, nbits]
        wbit = np.where(acc_any[:, :, None], 2.0 * bits - 1.0,
                        0.0).transpose(1, 2, 0)  # [Lmax, nbits, P]
        npos = (bits * acc_any[:, :, None]).sum(axis=(1, 2))  # [P]
        if npos.size and npos.min() < 1:
            return None  # an all-zero-id pattern can't outrank the dead id
        from .microhit import BITCLS, filter_weights

        bitcls = tuple(BITCLS + b for b in range(nbits))
        W, thr, classes = filter_weights(
            t, 0, False, bitw=(wbit, bitcls, npos))
        # exact rescore weights in class-id space (injective by
        # construction: distinct ids <=> distinct accept columns)
        alpha_r = 1 << nbits
        wconv = np.zeros((Lmax, alpha_r, P), np.float32)
        for c in live:
            np.maximum(wconv[:, clsid[c], :],
                       acc[:, :, c].T.astype(np.float32),
                       out=wconv[:, clsid[c], :])
        lut = np.full(256, dead, np.uint8)
        lut[:alpha] = np.where(clsid >= 0, clsid, dead).astype(np.uint8)
        self._route(
            "exact class-ENCODE bit-plane filter (%d live classes -> "
            "%d ids -> %d bit planes, exact margins)"
            % (len(live), ncls, nbits))
        return {
            "W": jnp.asarray(W), "thr": jnp.asarray(thr),
            "classes": classes,
            "wconv": jnp.asarray(wconv),
            "lut": jnp.asarray(lut),
            "alpha_r": alpha_r, "eos_r": int(dead),
        }

    def _fused_dispatch(self, codes_dev, cap_mb: int, hit_cap: int):
        """Launch the fused scan (no sync) — one device call.

        The jitted callable is PRE-BOUND per caps: the static kwargs are
        closed over once.  The table arrays stay ORDINARY ARGUMENTS:
        closing over concrete arrays bakes them into the lowered module
        as constants and keys the compile cache on table *values*."""
        bm = self._bitplane_mode()
        if bm is not None:
            codes_dev = _bit_form(codes_dev, bm["lut"])
        fn = self._dispatch_cache.get((cap_mb, hit_cap))
        if fn is None:
            fn = self._bind_dispatch(cap_mb, hit_cap)
        return fn(codes_dev)

    def _filter_weights(self):
        """Folded filter weights (a superset filter; the pipeline's exact
        rescore resolves them)."""
        from .microhit import filter_weights

        if self._filter_wt is None:
            W, thr, classes = filter_weights(
                self.tables, self.k, self.poison_eos)
            self._filter_wt = (jnp.asarray(W), jnp.asarray(thr), classes)
        return self._filter_wt

    _filter_wt_exact = None

    def _filter_weights_exact(self):
        """UNFOLDED filter weights (margins exact, not just a superset
        filter) — the filter's per-position hit extraction's form."""
        from .microhit import filter_weights

        if self._filter_wt_exact is None:
            W, thr, classes = filter_weights(
                self.tables, self.k, self.poison_eos, fold=False)
            self._filter_wt_exact = (
                jnp.asarray(W), jnp.asarray(thr), classes)
        return self._filter_wt_exact

    def _bind_dispatch(self, cap_mb: int, hit_cap: int):
        t = self.tables
        bm = self._bitplane_mode()
        if bm is not None:
            # bit-plane mode: recoded text (see _fused_dispatch), bit
            # weights, mask-/id-indexed exact-rescore weights; alpha_r =
            # 16 mask values (IUPAC) or 2^nbits class ids (exact
            # encode), EOS -> a value accepted by nothing
            W, thr, classes = bm["W"], bm["thr"], bm["classes"]
            alpha_r, eos_r, weights = (
                bm["alpha_r"], bm["eos_r"], bm["wconv"])
        else:
            W, thr, classes = self._filter_weights()
            alpha_r, eos_r, weights = t.alpha, t.eos_code, self.weights
        thresholds, lengths = self.thresholds, self.lengths_dev
        jfn = _shared_scan_jit(
            classes, alpha_r, t.Lmax, eos_r, self._MB, cap_mb, hit_cap)

        def fn(codes_dev):
            return jfn(codes_dev, W, thr, weights, thresholds, lengths)

        self._dispatch_cache[(cap_mb, hit_cap)] = fn
        return fn

    # -- fused gated pipeline (pigeonhole k>0 engines) -----------------------

    def gated_available(self, n: int) -> bool:
        """The fused seed-scan + extension-gate pipeline runs when the
        fused scan would — the k>0 engines use it to keep the dense seed
        hits AND the almost-always-failing extensions on device, fetching
        only gate survivors.  Under a multi-device mesh it runs
        data-parallel per shard (parallel.shard.sharded_scan_gated).
        Huge pattern sets (> _PBLOCK) take the pattern-blocked plain
        pipeline."""
        # order matters for one-shot latency: ``use_fused`` LAST — its
        # first read initializes the jax backend, which a host-served
        # one-shot run must never pay
        return bool(self.tables.P <= self._PBLOCK
                    and (self.force_device or n >= (1 << 20))
                    and not self._host_eligible(n)
                    and self.use_fused
                    and (n <= self._RESIDENT_DEFAULT
                         or n <= self._resident_max()))

    def scan_gated(self, codes: np.ndarray, gate, indels: bool, k: int):
        """One gated scan: returns (anchors [C] int64, sids [C] int32,
        multi_starts [M] int64) where (anchor, sid) are gate-surviving
        seed candidates (sid 0-based, anchor = seed end position) and
        multi_starts are window start positions where MORE THAN ONE seed
        hit — the caller rescans those exactly and must ignore survivor
        entries at those starts (the device gated only the top seed
        there)."""
        gt = gate.t if hasattr(gate, "t") else gate
        if self.mesh is not None and self.mesh.devices.size > 1:
            from ..parallel.shard import sharded_scan_gated

            self._route("gated pipeline sharded over %d devices (P=%d, "
                        "Lmax=%d, k=%d)" % (self.mesh.devices.size,
                                            self.tables.P, self.tables.Lmax,
                                            self.k))
            return sharded_scan_gated(self, gt, indels, k,
                                      np.asarray(codes), self.mesh)
        codes_dev = _device_form(codes)
        self._route(
            "fused gated pipeline (P=%d, Lmax=%d, k=%d)"
            % (self.tables.P, self.tables.Lmax, self.k))
        # NO _expected_hits presizing here: the pigeonhole estimate is off
        # by ~10x for mixed-length seed sets (it assumes every seed is
        # Lmin long), and oversized caps cost a giant rescore im2col every
        # scan; the first dispatch reports true counts and the sticky
        # retry converges in one step
        while True:
            caps = self._gated_caps()
            res = self._gated_dispatch(codes_dev, gate, indels, k, caps)
            packed = np.asarray(jax.device_get(res))
            if not self._gated_grow(packed, caps):
                break
        return self._gated_unpack(packed, caps)

    @staticmethod
    def _gated_unpack(packed, caps):
        """(anchors, sids, multi) from a fetched gated row whose counts
        fit ``caps`` (layout: :func:`.microhit.scan_gated`)."""
        multi_count, surv_count = int(packed[2]), int(packed[3])
        surv_cap = caps[3]
        anchors = packed[4 : 4 + surv_count].astype(np.int64)
        sids = packed[4 + surv_cap : 4 + surv_cap + surv_count].astype(
            np.int32)
        multi = packed[
            4 + 2 * surv_cap : 4 + 2 * surv_cap + multi_count
        ].astype(np.int64)
        return anchors, sids, multi

    _gcap_mb = 1 << 14
    _ghit_cap = 1 << 15
    _gmulti_cap = 256
    _gsurv_cap = 1 << 12

    def _gated_caps(self):
        return (self._gcap_mb, self._ghit_cap, self._gmulti_cap,
                self._gsurv_cap)

    def _gated_grow(self, packed, caps) -> bool:
        """True (and the caps grown past the true counts) when a gated
        row overflowed any of ``caps``.  Sticky at CLASS level: engines
        rebuild scanners per run and re-converging caps from the
        defaults would re-dispatch (and on a cold cache re-compile) the
        undersized config every time."""
        counts = [int(packed[i]) for i in range(4)]
        if all(c <= cap for c, cap in zip(counts, caps)):
            return False
        cls = type(self)
        cls._gcap_mb, cls._ghit_cap, cls._gmulti_cap, cls._gsurv_cap = (
            max(cap, 1 << (max(c, 1) - 1).bit_length())
            for c, cap in zip(counts, caps))
        return True

    def scan_gated_stream(self, blocks, gate, indels: bool, k: int):
        """Gated scans over an iterator of flat code arrays: run i+1's
        device pipeline is dispatched before run i's survivors are
        fetched, so the host tail of one run overlaps the next run's
        device work.  Yields (i, anchors, sids, multi) in order; runs
        the fused route cannot take go through :meth:`scan_gated`."""
        prev = None

        def collect(i, codes, res, caps):
            packed = np.asarray(jax.device_get(res))
            if self._gated_grow(packed, caps):
                return (i,) + self.scan_gated(codes, gate, indels, k)
            return (i,) + self._gated_unpack(packed, caps)

        for i, codes in enumerate(blocks):
            if (self.mesh is not None and self.mesh.devices.size > 1) \
                    or not self.gated_available(len(codes)):
                if prev is not None:
                    yield collect(*prev)
                    prev = None
                yield (i,) + self.scan_gated(codes, gate, indels, k)
                continue
            caps = self._gated_caps()
            res = self._gated_dispatch(_device_form(codes), gate, indels,
                                       k, caps)
            if prev is not None:
                yield collect(*prev)
            prev = (i, codes, res, caps)
        if prev is not None:
            yield collect(*prev)

    def rescan_starts_arrays(self, codes: np.ndarray, starts):
        """Exact host rescan of window start positions against the full
        accept table (the gated pipeline's multi-seed escape), vectorized
        over the whole start array: returns (starts [M] int64,
        pids_0based [M] int64) for every pattern hitting there, in
        (start, pid) order."""
        t = self.tables
        n = len(codes)
        starts = np.sort(np.asarray(starts, dtype=np.int64))
        if not len(starts):
            return (np.zeros(0, np.int64),) * 2
        # windows via a clipped gather — NO full-array pad copy (the old
        # np.concatenate([codes, pad]) duplicated the whole database per
        # rescan call: ~1.5 ms of the k=1 serving tail for ONE escape);
        # positions past the end fill with the device rescore's pad code
        # (eos, or code 0 when the table has no EOS class)
        fill = max(t.eos_code, 0)
        idx = starts[:, None] + np.arange(t.Lmax)
        wins = np.ascontiguousarray(
            codes[np.minimum(idx, n - 1)])  # [M, Lmax]
        wins[idx >= n] = fill
        # scores[m, p] = sum_j match[p, j, wins[m, j]]
        m3 = t.match.transpose(1, 2, 0)  # [Lmax, alpha, P]
        sc = np.zeros((len(starts), t.P), dtype=np.int32)
        for j in range(t.Lmax):
            sc += m3[j, wins[:, j], :]
        mi, pi = np.nonzero(sc >= (t.lengths - self.k)[None, :])
        return starts[mi], pi.astype(np.int64)

    def rescan_starts(self, codes: np.ndarray, starts):
        """Generator form of :meth:`rescan_starts_arrays`."""
        st, pi = self.rescan_starts_arrays(codes, np.asarray(list(starts)))
        for i in range(len(st)):
            yield int(st[i]), int(pi[i])

    def _gated_dispatch(self, codes_dev, gate, indels: bool, k: int, caps):
        from .microhit import pos_exact_ok

        t = self.tables
        exact_pos = pos_exact_ok(t, self.k)
        if exact_pos:
            # per-position extraction wants the UNFOLDED (exact-margin)
            # weights; no rescore pass exists in that mode
            W, thr, classes = self._filter_weights_exact()
        else:
            W, thr, classes = self._filter_weights()
        gt = gate.t if hasattr(gate, "t") else gate
        jfn = _shared_gated_jit(
            classes, t.alpha, t.Lmax, t.eos_code, self._MB,
            caps[0], caps[1], caps[2], caps[3],
            gt.Lg, k, gt.band, indels, exact_pos)
        return jfn(codes_dev, W, thr, self.weights, self.thresholds,
                   self.lengths_dev, gt.bits, gt.glen, gt.gdir)

    def _fused_decode(self, res, codes_dev, n: int, caps=None):
        """Sync one dispatched result (a single packed int32 array — one
        device-to-host copy), retrying with larger caps on overflow, and
        yield (end, pid, mism) tuples."""
        packed = np.asarray(jax.device_get(res))
        yield from self._decode_packed(packed, codes_dev, n, caps)

    def _decode_packed(self, packed, codes_dev, n: int, caps=None):
        """Decode an already-fetched packed result row, retrying with
        larger caps on overflow (a fresh dispatch + solo fetch; rare)."""
        cap_mb, hit_cap = caps or (self._cap_mb, self._hit_cap)
        mb_count, hit_count = int(packed[0]), int(packed[1])
        if mb_count > cap_mb or hit_count > hit_cap:
            yield from self._redispatch(codes_dev, n, mb_count, hit_count)
            return
        mb_idx = packed[2 : 2 + cap_mb]
        hits = packed[2 + cap_mb : 2 + cap_mb + hit_cap]
        if cap_mb * self._MB * self.tables.P < (1 << 24):
            # mism rides the hit word's high byte (microhit.scan_hits)
            hit_idx = hits & 0x00FFFFFF
            hit_mism = hits >> 24
        else:
            hit_idx = hits
            hit_mism = packed[2 + cap_mb + hit_cap :]
        yield from self._emit(hit_count, mb_idx, hit_idx, hit_mism, n)

    def _redispatch(self, codes_dev, n: int, mb_count: int,
                    hit_count: int):
        """Overflow retry: grow the caps past the observed true counts,
        rerun the scan, and decode solo.  Recursion through
        :meth:`_fused_decode` covers the case where a grown ``cap_mb``
        exposes new hits past the grown ``hit_cap``; caps grow
        monotonically so it terminates."""
        cap_mb = max(self._cap_mb,
                     1 << int(max(mb_count, 1) - 1).bit_length())
        hit_cap = max(self._hit_cap,
                      1 << int(max(hit_count, 1) - 1).bit_length())
        self._cap_mb = max(self._cap_mb, cap_mb)
        self._hit_cap = max(self._hit_cap, hit_cap)
        res = self._fused_dispatch(codes_dev, cap_mb, hit_cap)
        yield from self._fused_decode(res, codes_dev, n, (cap_mb, hit_cap))

    def _emit(self, hit_count: int, mb_idx, hit_idx, hit_mism, n: int):
        """Yield (end, pid, mism) tuples from live result sections.
        ``mb_idx`` may be just the live prefix: hit words only reference
        slots below the true microblock count (pad windows carry the
        ``compact_mask`` fill index >= nmb and are masked on device)."""
        if hit_count == 0:
            return
        t = self.tables
        lengths = t.lengths
        P = t.P
        MB = self._MB
        idx = hit_idx[:hit_count].astype(np.int64)
        ms = hit_mism[:hit_count]
        slot = idx // (MB * P)
        win = (idx // P) % MB
        pid = idx % P
        starts = mb_idx[slot].astype(np.int64) * MB + win
        keep = starts < n
        starts, pid, ms = starts[keep], pid[keep], ms[keep]
        ends = starts + lengths[pid]
        for e, p, m in zip(ends, pid, ms):
            yield int(e), int(p), int(m)

    # candidate-buffer floors: true candidate counts on non-degenerate
    # corpora are tiny (tens per 16 MB block), and every downstream stage
    # (rescan gather, hit-mask compaction, result fetch) scales with the
    # caps, so small floors buy real throughput; `_expected_hits` raises
    # them up-front for dense configs and overflow retries grow them
    # stickily
    _cap_mb = 128
    _hit_cap = 512
    # optional per-block progress callback (frac in (0,1]) — the reference's
    # report_progress protocol (pattern_match.h:144-155), attached by the
    # model when the driver runs verbose
    progress = None

    def _expected_hits(self, n: int) -> float:
        """Crude expected candidate count on random text: n * P /
        alpha^(Lmin-k).  Steers the route choice and initial caps."""
        t = self.tables
        lmin = int(t.lengths.min()) if len(t.lengths) else 1
        eff = max(lmin - self.k, 1)
        sigma = max(t.alpha - 1, 2)  # alphabet minus the EOS code
        try:
            return float(n) * t.P / float(sigma) ** eff
        except OverflowError:
            return 0.0

    _mer_tables_c = None
    _by_len_c = None

    @staticmethod
    def _mer_lib_ok() -> bool:
        """The native mer-hash machine is loadable: past _PBLOCK the
        dense device correlation is FLOP-bound (O(n * P * K)) and the
        threaded hash probe beats it outright, so huge-P exact scans
        prefer the census even when a device path exists."""
        from ..native import load_shift_and_lib

        lib = load_shift_and_lib()
        return lib is not None and hasattr(lib, "sat_mer_scan")

    def _mer_native(self, by_len: dict, codes: np.ndarray, n: int,
                    sort: bool = True, gate=None):
        """(ends, pids0) arrays via the native threaded mer-hash scan
        (``native/shift_and.cpp::sat_mer_scan``), or None when the
        library is unavailable.  Open-addressing tables (4x load factor
        headroom, duplicate codes chained) build once per scanner."""
        import ctypes

        from ..native import load_shift_and_lib

        lib = load_shift_and_lib()
        if lib is None or not hasattr(lib, "sat_mer_scan"):
            return None
        t = self.tables
        if self._mer_tables_c is None:
            tabs = {}
            for L, entries in by_len.items():
                P_L = len(entries)
                tsize = 1 << max(int(np.ceil(np.log2(4 * P_L + 1))), 4)
                keys = np.full(tsize, ~np.uint64(0), np.uint64)
                head = np.full(tsize, -1, np.int32)
                enext = np.full(P_L, -1, np.int32)
                epid = np.zeros(P_L, np.int32)
                GOLD = 0x9E3779B97F4A7C15
                U64 = (1 << 64) - 1
                mask = tsize - 1
                # bloom prefilter sized to the pattern count (a fixed
                # 2^19-bit filter saturates to ~17% false positives at
                # P = 100k half-seeds): ~2^5 bits per key caps the FP
                # rate at ~3% while staying cache-resident
                bloom_bits = min(max(19, P_L.bit_length() + 5), 26)
                bloom = np.zeros(1 << (bloom_bits - 6), np.uint64)
                GOLD2 = 0xC2B2AE3D27D4EB4F
                bshift = 64 - bloom_bits
                for e, (c, pi) in enumerate(entries):
                    epid[e] = pi
                    b = ((c * GOLD2) & U64) >> bshift
                    bloom[b >> 6] |= np.uint64(1 << (b & 63))
                    slot = (((c * GOLD) & U64) >> 32) & mask
                    while keys[slot] != ~np.uint64(0) \
                            and keys[slot] != np.uint64(c):
                        slot = (slot + 1) & mask
                    if keys[slot] == ~np.uint64(0):
                        keys[slot] = np.uint64(c)
                        head[slot] = e
                    else:  # duplicate code: push onto the chain
                        enext[e] = head[slot]
                        head[slot] = e
                # direct-address sidecar for base-4 (DNA) seed classes
                # with 2L <= 22 index bits: head4[code4] kills the
                # bloom + key-compare + open-addressing walk (one load
                # per position, <= 16 MB L3-resident table —
                # shift_and.cpp::mer_scan_range_d4)
                head4 = enext4 = bit4 = None
                if 2 * L <= 22 and P_L:
                    pids_L = np.fromiter((pi for _, pi in entries),
                                         np.int64, P_L)
                    dig = np.asarray(t.pat_codes, np.int64)[pids_L, :L]
                    if (dig >= 0).all() and (dig < 4).all():
                        code4 = np.zeros(P_L, np.int64)
                        for j in range(L):
                            code4 = (code4 << 2) | dig[:, j]
                        head4 = np.full(1 << (2 * L), -1, np.int32)
                        enext4 = np.full(P_L, -1, np.int32)
                        for e, c4 in enumerate(code4.tolist()):
                            enext4[e] = head4[c4]
                            head4[c4] = e
                        # exact presence bitmap (4^L bits, L2-resident):
                        # the sweep tests this instead of touching the
                        # (up to 16 MB) head table per position
                        packed = np.packbits(head4 >= 0,
                                             bitorder="little")
                        if len(packed) % 8:
                            packed = np.concatenate(
                                [packed, np.zeros(8 - len(packed) % 8,
                                                  np.uint8)])
                        bit4 = np.ascontiguousarray(
                            packed).view(np.uint64)
                tabs[L] = (keys, head, enext, epid, tsize, bloom,
                           bloom_bits, head4, enext4, bit4)
            self._mer_tables_c = tabs
        tabs = self._mer_tables_c
        codes8 = np.ascontiguousarray(np.asarray(codes, np.uint8))
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_u64p = ctypes.POINTER(ctypes.c_uint64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i8p = ctypes.POINTER(ctypes.c_int8)
        # optional inline prefix extension gate (mer_gate_pass): a
        # per-pattern (dir, prefix codes, len, G, k, band) superset
        # filter evaluated on the scan threads — candidates it rejects
        # could not survive the exact extension
        if gate is not None:
            gdir, gpref, gglen, gG, gk, gband = gate
            if os.environ.get("SAT_MER_ABLATE") == "gate":
                # bench-insurance breakage proof (bench.py): force the
                # inline gate to over-prune (k=0 tolerance) so a broken
                # mer_gate_pass demonstrably trips the row validators
                gk = 0
            # pack the per-pattern gate metadata into ONE uint64/pattern
            # when it fits (G <= 6, i.e. k <= 2): the three-array form
            # costs ~3 random cache lines per gated candidate and
            # measured ~2/3 of the whole inline-gate cost at xmers
            # phase-2 rates (see shift_and.cpp::mer_gate_pass_packed)
            gpack = None
            if gG <= 6:
                cached = self._mer_gpack_c
                if cached is not None and cached[0] is gdir:
                    gpack = cached[1]
                else:
                    d64 = np.where(gdir > 0, 1,
                                   np.where(gdir < 0, 2, 0)).astype(
                                       np.uint64)
                    g64 = d64 | (gglen.astype(np.uint64) << np.uint64(2))
                    pref = gpref.reshape(-1, gG).astype(np.uint64)
                    for j in range(gG):
                        g64 |= pref[:, j] << np.uint64(16 + 8 * j)
                    gpack = np.ascontiguousarray(g64)
                    self._mer_gpack_c = (gdir, gpack)
            gate_args = (gdir.ctypes.data_as(c_i8p),
                         gpref.ctypes.data_as(c_u8p),
                         gglen.ctypes.data_as(c_u8p), gG, gk, gband,
                         gpack.ctypes.data_as(c_u64p)
                         if gpack is not None else None)
        else:
            gate_args = (None, None, None, 0, 0, 0, None)
        d4fn = getattr(lib, "sat_mer_scan_d4", None)
        all_s, all_p = [], []
        for L, (keys, head, enext, epid, tsize, bloom,
                bloom_bits, head4, enext4, bit4) in tabs.items():
            if n < L:
                continue
            # direct-address walk when the class has a base-4 table and
            # the gate (if any) rides the packed record
            use_d4 = (d4fn is not None and head4 is not None
                      and (gate is None or gate_args[6] is not None))
            if use_d4:
                pack, bad = self._mer_pack(codes8, n)
            cap = max(4 * len(epid) + (n >> 6), 1 << 14)
            while True:
                # reused across scans: a fresh 4P-row np.empty pair
                # costs ~1-2 ms of page faults per call at xmers scale
                buf = self._mer_outbuf_c
                if buf is None or len(buf[0]) < cap:
                    buf = (np.empty(cap, np.int64), np.empty(cap, np.int32))
                    self._mer_outbuf_c = buf
                out_s, out_p = buf
                if use_d4:
                    total = d4fn(
                        codes8.ctypes.data_as(c_u8p),
                        pack.ctypes.data_as(c_u8p),
                        bad.ctypes.data_as(c_i64p), len(bad), n, L,
                        head4.ctypes.data_as(c_i32p),
                        enext4.ctypes.data_as(c_i32p),
                        epid.ctypes.data_as(c_i32p),
                        bit4.ctypes.data_as(c_u64p),
                        gate_args[4], gate_args[5], gate_args[6], 0,
                        out_s.ctypes.data_as(c_i64p),
                        out_p.ctypes.data_as(c_i32p), cap)
                else:
                    total = lib.sat_mer_scan(
                        codes8.ctypes.data_as(c_u8p), n, L, t.alpha,
                        keys.ctypes.data_as(c_u64p),
                        head.ctypes.data_as(c_i32p),
                        enext.ctypes.data_as(c_i32p),
                        epid.ctypes.data_as(c_i32p), tsize,
                        bloom.ctypes.data_as(c_u64p), bloom_bits,
                        *gate_args, 0,
                        out_s.ctypes.data_as(c_i64p),
                        out_p.ctypes.data_as(c_i32p), cap)
                if total < 0:
                    return None
                if total <= cap:
                    break
                cap = 1 << (int(total) - 1).bit_length()
            # COPY out of the reused buffer: the next length class's
            # native call would overwrite these views
            all_s.append(out_s[: int(total)].copy())
            all_p.append(out_p[: int(total)].astype(np.int64))

        if not all_s:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts = all_s[0] if len(all_s) == 1 else np.concatenate(all_s)
        pids = all_p[0] if len(all_p) == 1 else np.concatenate(all_p)
        if os.environ.get("SAT_MER_ABLATE") == "scan":
            # bench-insurance breakage proof: drop every odd-start hit
            # from the NATIVE census output only — a broken sat_mer_scan
            # must make the bench row validators fire
            sel = (starts & 1) == 0
            starts, pids = starts[sel], pids[sel]
        if sort:
            order = np.lexsort((pids, starts))
            starts, pids = starts[order], pids[order]
        ends = starts + t.lengths[pids].astype(np.int64)
        return ends, pids

    _radix_ok_c = None
    _mer_outbuf_c = None
    _mer_gpack_c = None
    _mer_pack_cc = None

    def _mer_pack(self, codes8, n):
        """(pack, bad) for the direct-address census walk: the 2-bit
        MSB-first packed text (+pad bytes so the kernel's 8-byte loads
        never run off the end) and the sorted positions of chars with
        code >= 4 (EOS/ambiguity — base-4 masking would alias them).
        Static per database, cached by buffer identity: the resident-DB
        serving path re-scans the same array every run."""
        # identity by OBJECT (held strongly), not by buffer address: a
        # fresh array can legally reuse a freed buffer's address, and a
        # stale (pack, bad) against new codes is silently wrong output.
        # The resident serving path passes the same uint8 array object
        # every run (ascontiguousarray is a no-op there), so the cache
        # still hits where it matters.
        cached = self._mer_pack_cc
        if cached is not None and cached[0] is codes8 and cached[1] == n:
            return cached[2], cached[3]
        m = (n + 3) // 4
        padded = np.zeros(4 * m, np.uint8)
        padded[:n] = codes8[:n]
        q = (padded & 3).reshape(m, 4)
        pack = np.concatenate([
            (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3],
            np.zeros(16, np.uint8)])
        pack = np.ascontiguousarray(pack)
        bad = np.flatnonzero(codes8[:n] >= 4).astype(np.int64)
        self._mer_pack_cc = (codes8, n, pack, bad)
        return pack, bad

    def scan_seed_arrays(self, codes: np.ndarray, sort: bool = True,
                         gate=None):
        """(ends, pids0) int64 arrays when an array-native host census
        serves this scan (the same routing test as :meth:`scan`'s radix
        branch); None otherwise — callers fall back to iterating
        :meth:`scan`.  Skips the per-hit tuple stream entirely: at
        xmers scale (100k seeds, ~10^5 hits) the generator hops cost
        more than the census itself."""
        n = len(codes)
        # NOTE: no _sharded_capable() bail (round 5, VERDICT r4 item 4a):
        # the census is HOST-side work — dense exact seeds degenerate the
        # device two-level filter with or without a mesh, so a pigeonhole
        # engine the gated pipeline cannot take routes its seed scan here
        # at any device count (output identical)
        if self._stream_whole(codes) or self._host_eligible(n):
            return None
        est = self._expected_hits(n)
        nmb = max(n // self._MB, 1)
        dev_ok = self.use_fused and (
            self.force_device or n >= (1 << 20))
        if not (self.k == 0 and n >= (1 << 18)
                and (est * 4 >= nmb
                     or (self.tables.P > self._PBLOCK
                         and (not dev_ok or self._mer_lib_ok())))
                and self._radix_eligible()):
            return None
        return self._scan_radix_arrays(self._by_len(), codes, n, sort=sort,
                                       gate=gate)

    def _radix_eligible(self) -> bool:
        """Radix lookup needs literal (wildcard-free) patterns and codes
        that fit an int64 base-alpha register.  Cached: the per-pattern
        sweep costs ~0.15 s at P = 50k and tables never change."""
        if self._radix_ok_c is not None:
            return self._radix_ok_c
        t = self.tables
        ok = t.Lmax * np.log2(max(t.alpha, 2)) < 62
        if ok:
            cols = np.arange(t.pat_codes.shape[1])[None, :]
            live = cols < t.lengths[:, None]
            ok = not bool((np.asarray(t.pat_codes) < 0)[live].any())
        self._radix_ok_c = ok
        return ok

    def _scan_radix(self, codes: np.ndarray):
        """Exact multi-pattern scan as a host radix-code census: rolling
        base-alpha window codes per distinct pattern length, matched by
        binary search against the sorted pattern codes.  The hash_table
        engine's direct-indexed lookup (hash_table.cc:144-226) as a
        whole-array vector pass.  When the native threaded mer-hash
        machine is available it takes over (one rolling probe per
        position instead of L numpy passes — the huge-P regime where a
        dense device correlation costs O(n * P * K))."""
        ends, pids = self._scan_radix_arrays(self._by_len(), codes,
                                             len(codes))
        e_l = ends.tolist()
        p_l = pids.tolist()
        yield from zip(e_l, p_l, [0] * len(e_l))

    def _by_len(self):
        """{length: [(code, pid0)]} — vectorized per-length base-alpha
        code build, cached per scanner (the per-pattern python loop
        costs ~0.35 s at P = 50k PER SCAN)."""
        if self._by_len_c is None:
            t = self.tables
            alpha = t.alpha
            by_len: dict[int, list] = {}
            lens = t.lengths.astype(np.int64)
            pc = np.asarray(t.pat_codes, np.int64)
            for L in np.unique(lens):
                L = int(L)
                sel = np.flatnonzero(lens == L)
                codes_L = np.zeros(len(sel), np.int64)
                for j in range(L):
                    codes_L = codes_L * alpha + pc[sel, j]
                by_len[L] = list(zip(codes_L.tolist(), sel.tolist()))
            self._by_len_c = by_len
        return self._by_len_c

    def _scan_radix_arrays(self, by_len, codes, n, sort=True, gate=None):
        """(ends, pids0) int64 arrays in (window-start, pattern) order —
        the array core of :meth:`_scan_radix`.  ``sort=False`` skips the
        final (start, pattern) lexsort for callers that re-order anyway
        (the pigeonhole emit tails) — ~20 ms per 200k hits."""
        t = self.tables
        alpha = t.alpha
        native = self._mer_native(by_len, codes, n, sort=sort, gate=gate)
        if native is not None:
            self._route("native threaded mer-hash census "
                        "(%d patterns)" % t.P)
            return native
        self._route("host radix-code census (numpy)")
        # int32 rolling codes when they fit (alpha^Lmax < 2^31) — halves the
        # memory traffic of the dominant update loop; in-place ops avoid
        # reallocating the 4n-byte id array per pattern position
        small = max(by_len) * np.log2(max(alpha, 2)) < 31 if by_len else True
        dt = np.int32 if small else np.int64
        cN = codes.astype(dt)
        all_starts = []
        all_pids = []
        for L, entries in by_len.items():
            if n < L:
                continue
            ids = cN[: n - L + 1].copy()
            for j in range(1, L):
                ids *= dt(alpha)
                ids += cN[j : j + n - L + 1]
            ids = ids.astype(np.int64, copy=False)
            entries.sort()
            scodes = np.fromiter((c for c, _ in entries), np.int64,
                                 len(entries))
            uniq, first = np.unique(scodes, return_index=True)
            pos = np.searchsorted(uniq, ids)
            pos = np.minimum(pos, len(uniq) - 1)
            starts = np.nonzero(uniq[pos] == ids)[0]
            ci = pos[starts]
            # one emission per matching pattern; duplicate pattern codes
            # (identical patterns) fan out
            counts = np.diff(np.append(first, len(scodes)))
            order = np.argsort(uniq)  # identity; uniq sorted
            del order
            for rep in range(int(counts.max(initial=1))):
                sel = counts[ci] > rep
                if not sel.any():
                    break
                idx = first[ci[sel]] + rep
                all_starts.append(starts[sel])
                all_pids.append(
                    np.fromiter((entries[i][1] for i in idx), np.int64,
                                len(idx)))
        if not all_starts:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts = np.concatenate(all_starts)
        pids = np.concatenate(all_pids)
        order = np.lexsort((pids, starts))
        starts, pids = starts[order], pids[order]
        ends = starts + t.lengths[pids].astype(np.int64)
        return ends, pids

    # -- pattern-blocked outer loop (P > _PBLOCK) ----------------------------

    # one fused-pipeline pass handles at most this many patterns: the
    # filter's unrolled expression and the rescore's [candidates, P]
    # score tensor both scale with P, so huge sets (xmers -b 50000
    # phase-1 batches, xmers.cc:821; nrdb's one seed per database
    # sequence, nrdb.cc:196-220) run as ceil(P / _PBLOCK) passes over
    # the SAME resident text (the codes upload is cached by array
    # identity — each extra pass costs only its own weights and scan)
    _PBLOCK = 2048
    _pblock_subs_c = None

    def _pblock_subs(self):
        """Sub-scanners over <= _PBLOCK-pattern table slices, built once
        per scanner (their converged candidate caps persist across
        scans)."""
        if self._pblock_subs_c is None:
            from .tables import PatternTables

            t = self.tables
            subs = []
            for off in range(0, t.P, self._PBLOCK):
                sl = slice(off, min(off + self._PBLOCK, t.P))
                st = PatternTables(
                    match=t.match[sl], lengths=t.lengths[sl],
                    pat_codes=t.pat_codes[sl], Lmax=t.Lmax,
                    alpha=t.alpha, eos_code=t.eos_code,
                    code_chars=t.code_chars,
                )
                sub = ConvScanner(st, k=self.k, poison_eos=self.poison_eos,
                                  block=self.block, use_fused=True)
                sub.force_device = self.force_device
                sub.use_host = False
                subs.append((off, sub))
            self._pblock_subs_c = subs
        return self._pblock_subs_c

    def _scan_pblocked(self, codes: np.ndarray):
        """Pattern-blocked fused scan: ALL passes dispatch before any
        result is fetched (the device queues them back to back; the
        device-to-host copies overlap the later passes' compute), then
        hits merge to the global (window-start, pattern) order."""
        codes_dev = _device_form(codes)
        n = len(codes)
        pending = []
        for off, sub in self._pblock_subs():
            est = int(sub._expected_hits(n) * 4) + 1
            if est > sub._hit_cap:
                sub._hit_cap = 1 << (est - 1).bit_length()
            if est > sub._cap_mb:
                nmb = max(n // sub._MB, 1)
                sub._cap_mb = 1 << (min(est, nmb) - 1).bit_length()
            caps = (sub._cap_mb, sub._hit_cap)
            res = sub._fused_dispatch(codes_dev, caps[0], caps[1])
            pending.append((off, sub, res, caps))
        # fetch packed rows in shape-grouped STACKS: one device-to-host
        # copy per group instead of per pass
        rows: dict = {}
        i = 0
        while i < len(pending):
            j = i + 1
            shape = pending[i][2].shape
            while j < len(pending) and pending[j][2].shape == shape:
                j += 1
            group = pending[i:j]
            if len(group) == 1:
                rows[i] = np.asarray(jax.device_get(group[0][2]))
            else:
                stacked = np.asarray(jax.device_get(
                    self._stack([g[2] for g in group])))
                for gi in range(len(group)):
                    rows[i + gi] = stacked[gi]
            i = j
        out = []
        for idx, (off, sub, _res, caps) in enumerate(pending):
            lens = sub.tables.lengths
            for end, p0, m in sub._decode_packed(
                    rows[idx], codes_dev, n, caps):
                out.append((end - int(lens[p0]), off + p0, end, m))
        out.sort()
        for _start, pid, end, m in out:
            yield end, pid, m

    def _scan_fused(self, codes: np.ndarray):
        """Fused single-round-trip scan: the microhit filter, candidate
        compaction, window rescore and hit extraction all run in one
        device call (:func:`.microhit.scan_hits`)."""
        codes_dev = _device_form(codes)
        # pre-size the candidate buffers from the expected density so the
        # overflow-retry (a fresh compile) stays rare
        est = int(self._expected_hits(len(codes)) * 4) + 1
        if est > self._hit_cap:
            self._hit_cap = 1 << (est - 1).bit_length()
        if est > self._cap_mb:
            nmb = max(len(codes) // self._MB, 1)
            self._cap_mb = 1 << (min(est, nmb) - 1).bit_length()
        caps = (self._cap_mb, self._hit_cap)
        res = self._fused_dispatch(codes_dev, caps[0], caps[1])
        yield from self._fused_decode(res, codes_dev, len(codes), caps)

    _stack_jit = None

    @classmethod
    def _stack(cls, rs):
        """On-device stack of same-shape packed results (one dispatch)."""
        if cls._stack_jit is None:
            cls._stack_jit = jax.jit(lambda *a: jnp.stack(a))
        return cls._stack_jit(*rs)

    _gcap = 1024  # group-fetch entry capacity (grows on group overflow)
    _fetch_exec = None

    def _fetch_pool(self):
        if self._fetch_exec is None:
            from concurrent.futures import ThreadPoolExecutor

            self._fetch_exec = ThreadPoolExecutor(max_workers=1)
        return self._fetch_exec

    def _launch_group(self, pending, count: int):
        """Pop the leading same-caps run (packed rows must share a
        layout; caps can grow after an overflow retry) and start its
        fetch in the background.  Returns an in-flight handle for
        :meth:`_drain_group`."""
        group = [pending.popleft()]
        while len(group) < count and pending and \
                pending[0][4] == group[0][4]:
            group.append(pending.popleft())
        caps = group[0][4]
        pool = self._fetch_pool()
        if len(group) == 1:
            fut = pool.submit(
                lambda r=group[0][1]: np.asarray(jax.device_get(r)))
            return ("solo", group, None, fut, 0, caps)
        # pad the stack to a power-of-two bucket by repeating the last row
        # (bounds the (#args, shape) jit specializations; pad entries land
        # AFTER every real row's segment, so they only ever truncate
        # themselves on gcap overflow)
        bucket = 1 << (len(group) - 1).bit_length()
        rs = [x[1] for x in group]
        rs += [rs[-1]] * (bucket - len(rs))
        stacked = self._stack(rs)
        long_form = caps[0] * self._MB * self.tables.P >= (1 << 24)
        gcap = self._gcap
        res = _pack_group(stacked, cap_mb=caps[0], hit_cap=caps[1],
                          gcap=gcap, long_form=long_form)
        fut = pool.submit(lambda r=res: np.asarray(jax.device_get(r)))
        return ("group", group, stacked, fut, gcap, caps)

    def _drain_group(self, inflight):
        """Wait for an in-flight group fetch and yield its
        (block_index, hits_list) results in order."""
        kind, group, stacked, fut, gcap, caps = inflight
        cap_mb, hit_cap = caps
        packed = fut.result()
        if kind == "solo":
            j, r, d, n, c = group[0]
            yield j, list(self._decode_packed(packed, d, n, c))
            return
        g = len(group)
        bucket = int(stacked.shape[0])
        mbc_t = packed[:g]
        hc_t = packed[bucket : bucket + g]
        mbc = np.minimum(mbc_t, cap_mb)
        hc = np.minimum(hc_t, hit_cap)
        # the pad rows' (duplicated last row) entries sit after all real
        # segments, so real segments are intact iff the REAL totals fit
        if int(mbc.sum()) > gcap or int(hc.sum()) > gcap:
            # group overflow: fall back to the full stacked fetch and
            # grow the entry capacity for subsequent groups
            need = max(int(mbc.sum()), int(hc.sum()))
            self._gcap = max(self._gcap, 1 << (need - 1).bit_length())
            rows = np.asarray(jax.device_get(stacked))
            for (j, r, d, n, c), row in zip(group, rows):
                yield j, list(self._decode_packed(row, d, n, c))
            return
        base = 2 * bucket
        mb_entries = packed[base : base + gcap]
        hit_entries = packed[base + gcap : base + 2 * gcap]
        long_form = cap_mb * self._MB * self.tables.P >= (1 << 24)
        mism_entries = packed[base + 2 * gcap :] if long_form else None
        mb_off = np.zeros(g + 1, np.int64)
        mb_off[1:] = np.cumsum(mbc, dtype=np.int64)
        hit_off = np.zeros(g + 1, np.int64)
        hit_off[1:] = np.cumsum(hc, dtype=np.int64)
        for gi, (j, r, d, n, c) in enumerate(group):
            if mbc_t[gi] > cap_mb or hc_t[gi] > hit_cap:
                yield j, list(self._redispatch(
                    d, n, int(mbc_t[gi]), int(hc_t[gi])))
                continue
            mb = mb_entries[mb_off[gi] : mb_off[gi + 1]]
            hv = hit_entries[hit_off[gi] : hit_off[gi + 1]]
            if long_form:
                hi, hm = hv, mism_entries[hit_off[gi] : hit_off[gi + 1]]
            else:
                hi, hm = hv & 0x00FFFFFF, hv >> 24
            yield j, list(self._emit(int(hc_t[gi]), mb, hi, hm, n))

    _STREAM_DEPTH = int(os.environ.get("SAT_STREAM_DEPTH", "256"))

    def scan_stream(self, blocks, depth: int | None = None):
        """Pipelined scan over an iterator of flat code arrays.

        Three-level latency hiding (the device computes a whole block in
        a few milliseconds; the host-side dispatch, copy and decode are
        the resources to schedule):

        - block i+1 is dispatched before block i's results are collected
          (device compute overlaps the host round-trip),
        - results are synced in GROUPS: when ``depth`` blocks are in
          flight, the oldest ``depth // 2`` are compacted ON DEVICE to
          their live entries (:func:`_pack_group` — true counts are tiny,
          so this turns a padded fetch into a few KB) and fetched with
          ONE ``device_get``, and
        - the fetch itself runs on a background thread, so the round-trip
          overlaps the dispatch of the NEXT ``depth // 2`` blocks instead
          of stalling the stream.

        Packed results are ~20 KB each, so a deep window costs ~5 MB of
        device memory on top of the in-flight input blocks (those
        dominate: depth x block bytes).

        Yields (block_index, hits_list) in order."""
        from collections import deque

        if depth is None:
            depth = self._STREAM_DEPTH
        if self._sharded_capable():
            from ..parallel.shard import sharded_scan_stream

            self._route(
                "sharded pipelined scan STREAM over %d devices "
                "(dispatch/fetch overlapped)" % self.mesh.devices.size)
            yield from sharded_scan_stream(
                self, blocks, self.mesh, depth=depth)
            return
        if not self.use_fused or self.tables.P > self._PBLOCK:
            # huge pattern sets stream block-by-block through the
            # pattern-blocked scan (each block is itself pipelined
            # across its ceil(P/_PBLOCK) passes)
            for i, codes in enumerate(blocks):
                yield i, list(self.scan(codes))
            return
        pending = deque()
        inflight = None
        for i, codes in enumerate(blocks):
            # reuse the device copy when the same host array repeats
            dev = _device_form(codes)
            caps = (self._cap_mb, self._hit_cap)
            res = self._fused_dispatch(dev, caps[0], caps[1])
            pending.append((i, res, dev, len(codes), caps))
            if len(pending) >= depth:
                if inflight is not None:
                    yield from self._drain_group(inflight)
                inflight = self._launch_group(pending, max(depth // 2, 1))
        while inflight is not None or pending:
            if inflight is not None:
                yield from self._drain_group(inflight)
                inflight = None
            if pending:
                inflight = self._launch_group(pending, len(pending))

    _host_scanner = None
    # tri-state: None = auto (small scans), False = never (pin a device
    # path), True = whenever the native machine can represent the patterns
    use_host = None

    def _host_eligible(self, n: int) -> bool:
        """Route to the native shift-and machine when the scan is small
        enough that fixed device costs (trace/compile, table upload,
        device round trips) dominate; never when a test forced the
        device route."""
        import os

        if self.use_host is False or self.force_device:
            return False
        if self.use_host is None and (self.k > 4 or n > (1 << 26)):
            return False
        if os.environ.get("SAT_HOST_SCAN", "1") == "0":
            return False
        if self._host_scanner is None:
            from .host_scan import HostShiftAnd

            self._host_scanner = HostShiftAnd(
                self.tables, self.k, self.poison_eos)
        return self._host_scanner.available()

    # streaming memory model (DB >> RAM / HBM): whole-array scans over a
    # np.memmap (or any array past the device-residency bound) run as
    # halo'd blocks through the pipelined scan_stream — bounded host AND
    # device memory, the reference's mmap streaming model (mapFile.h:6-55)
    _STREAM_BLOCK = 1 << 24   # positions per streamed block
    # largest array kept device-resident whole: the device's memory
    # limit over the bytes a resident scan holds per position (codes, its
    # padded and bit-mode copies, the filter's per-position int32 words,
    # compaction scratch — 16 leaves headroom).  On an 80 GB card with
    # three quarters reserved that is ~3.7 G positions, a whole human
    # genome.  Devices that report no limit (the CPU) keep 2^28.  A
    # first choice from that count, not a measured bound.
    _RESIDENT_BYTES_PER_POS = 16
    _RESIDENT_DEFAULT = 1 << 28
    _resident_max_c = None

    @classmethod
    def _resident_max(cls) -> int:
        if cls._resident_max_c is None:
            stats = jax.devices()[0].memory_stats() or {}
            limit = stats.get("bytes_limit")
            cls._resident_max_c = (
                limit // cls._RESIDENT_BYTES_PER_POS if limit
                else cls._RESIDENT_DEFAULT)
        return cls._resident_max_c

    def _stream_whole(self, codes) -> bool:
        n = len(codes)
        # arrays within the default bound never ask the device, so
        # host-routed scans stay free of backend start-up
        if n > self._RESIDENT_DEFAULT and n > self._resident_max():
            return True
        return isinstance(codes, np.memmap) and n > self._STREAM_BLOCK

    def _scan_flat_stream(self, codes):
        """Whole-array scan in streamed halo'd blocks: a window is owned
        by the block containing its start, so concatenating the rebased
        per-block streams IS the global (window-start, pattern) order.
        Each block is materialized (paging in only its window of the
        memmap), scanned via scan_stream's pipelined dispatch, and
        released; in-flight device blocks are bounded by ``depth``."""
        t = self.tables
        halo = t.Lmax - 1 + self.k
        B = self._STREAM_BLOCK
        n = len(codes)
        lengths = t.lengths
        # release consumed pages of a memory-mapped source as we go:
        # without this the kernel keeps every touched page resident and
        # RSS grows to the file size (breaking cgroup/container limits
        # long before actual memory pressure would)
        mm = getattr(codes, "_mmap", None) \
            if getattr(codes, "offset", 1) == 0 else None

        def blocks():
            import mmap as _mmap

            drop = mm if hasattr(_mmap, "MADV_DONTNEED") else None
            pg = _mmap.PAGESIZE
            for s in range(0, n, B):
                yield np.ascontiguousarray(codes[s : s + B + halo])
                if drop is not None:
                    try:
                        lo = s // pg * pg
                        drop.madvise(_mmap.MADV_DONTNEED, lo,
                                     min(s + B + halo, n) - lo)
                    except (ValueError, OSError):
                        drop = None

        nblocks = -(-n // B)
        if self._sharded_capable():
            # DB >> RAM *and* a mesh: every streamed block is itself
            # position-sharded over the chips (the multi-host north
            # star's memory model — the DB is big BECAUSE there are
            # many chips); ownership/rebase rules are identical
            from ..parallel.shard import sharded_scan_stream

            stream = sharded_scan_stream(
                self, blocks(), self.mesh, depth=4)
        else:
            stream = self.scan_stream(blocks(), depth=4)
        for i, hits in stream:
            base = i * B
            for end, pid, m in hits:
                if end - int(lengths[pid]) < B:  # halo-started: next block's
                    yield end + base, pid, m
            if self.progress:
                self.progress((i + 1) / nblocks)

    def scan(self, codes: np.ndarray):
        """Iterate candidate tuples over the whole array (host generator)."""
        if self._stream_whole(codes):
            self._route(
                "streamed block scan (DB >> RAM)"
                + (", sharded over %d devices" % self.mesh.devices.size
                   if self._sharded_capable() else ""))
            yield from self._scan_flat_stream(codes)
            return
        if self._sharded_capable():
            # explicit multi-chip intent wins over the single-host
            # latency heuristics: every chip scans its position shard
            # through the fused pipeline, hit rows ride one all_gather
            from ..parallel.shard import sharded_scan_hits

            self._route("fused microhit pipeline sharded over %d devices"
                        % self.mesh.devices.size)
            yield from sharded_scan_hits(self, codes, self.mesh)
            if self.progress:
                self.progress(1.0)
            return
        est = self._expected_hits(len(codes))
        nmb = max(len(codes) // self._MB, 1)
        # the shift-and machine beats the radix census whenever its state
        # fits (measured 15x on the dense 80-seed halves scan: the census
        # pays L passes over the whole code array per distinct length plus
        # a searchsorted, the bit machine one table step per char), so it
        # goes first; radix remains the huge-pattern-set dense-seed path
        # (hash/xmers seeds overflow the 4096-bit shift-and state)
        if self._host_eligible(len(codes)):
            self._route("native shift-and host machine "
                        "(one-shot latency path)")
            yield from self._host_scanner.scan(
                codes, cap_hint=int(est * 4) + 1024)
            if self.progress:
                self.progress(1.0)
            return
        dev_ok = self.use_fused and (
            self.force_device or len(codes) >= (1 << 20))
        if (self.k == 0 and len(codes) >= (1 << 18)
                and (est * 4 >= nmb
                     or (self.tables.P > self._PBLOCK
                         and (not dev_ok or self._mer_lib_ok())))
                and self._radix_eligible()):
            # dense exact seeds (pigeonhole halves/bases/hash engines):
            # nearly every microblock fires, which degenerates the
            # two-level device filter — a host radix-code lookup beats
            # the device paths here (no transfers, no compiles).  Huge
            # pattern sets with no device path also land here: the XLA
            # block fallback pays O(B * P) dense scores
            self._route("host radix census (dense exact seeds)")
            yield from self._scan_radix(codes)
            if self.progress:
                self.progress(1.0)
            return
        if dev_ok:
            # small inputs aren't worth the fused compile; the XLA block
            # path below is already instant there
            if self.tables.P > self._PBLOCK:
                self._route(
                    "pattern-blocked fused pipeline (%d patterns, "
                    "%d blocks)" % (self.tables.P,
                                    -(-self.tables.P // self._PBLOCK)))
                yield from self._scan_pblocked(codes)
            else:
                self._route("fused microhit scan pipeline")
                yield from self._scan_fused(codes)
            if self.progress:
                self.progress(1.0)
            return
        Lmax = self.tables.Lmax
        P = self.tables.P
        self._route(
            "XLA block-scan fallback (Lmax=%d%s, P=%d, k=%d, n=%d)"
            % (Lmax, " > %d: beyond the fused filter" % self._FUSED_LMAX
               if Lmax > self._FUSED_LMAX else "",
               P, self.k, len(codes)))
        n = len(codes)
        eos = self.tables.eos_code
        lengths = self.tables.lengths
        # the [B, P] hit grid is flat-indexed in int32 by the compaction;
        # huge pattern sets shrink the block to keep B * P < 2^31
        block = max(min(self.block, ((1 << 31) - 1) // max(P, 1) - Lmax), 8)
        for start in range(0, n, block):
            b = min(block, n - start)
            chunk = np.full(block + Lmax - 1, eos, dtype=np.uint8)
            avail = min(n - start, block + Lmax - 1)
            chunk[:avail] = codes[start : start + avail]
            cap = self.cap
            while True:
                packed = np.asarray(_conv_scan_block(
                    jnp.asarray(chunk), self.weights, self.thresholds,
                    self.lengths_dev, self.tables.alpha, cap,
                ))
                count = int(packed[0])
                if count <= cap:
                    break
                cap *= 4  # recompile with larger capacity (rare)
            if count == 0:
                if self.progress:
                    self.progress((start + b) / n)
                continue
            idx = packed[1 : 1 + count].astype(np.int64)
            mism = packed[1 + cap : 1 + cap + count]
            win = idx // P
            pid = idx % P
            keep = win < b  # windows starting beyond the true block are halo
            win, pid, mism = win[keep], pid[keep], mism[keep]
            ends = start + win + lengths[pid]
            for e, p, m in zip(ends, pid, mism):
                yield int(e), int(p), int(m)
            if self.progress:
                self.progress((start + b) / n)