"""Device-side seed-extension GATE: a vectorized banded DP that decides,
for every seed hit at once, whether the pigeonhole extension COULD succeed.

The reference extends every seed hit with a host DP and most extensions fail
(exact_halves.cc:120-197: a random half-match almost never completes to a
k-edit full match).  On device the seed scan finds tens of thousands of
seed hits per 16 MB block; fetching them to the host and running even a native DP
per hit is the k>0 bottleneck.  This gate runs a SUPERSET filter on device —

    gate(c) = [ min banded edit distance of the extension pattern anchored
                at the seed hit <= k ]   (constraints/EOS ignored)

— so only gate-passing candidates (almost exactly the true hits) are fetched
and re-extended with the exact native DP (engine/extend.py, the
primer_alignment.cc:10-299 semantics with tie-breaks and constraint
penalties).  Superset proof: the true extension DP's accept set per pattern
position is exactly ``accept``; its substitution/indel costs are >= the
gate's (dna_mut muts cost 1..3 vs 1; constraint/EOS violations cost 5k+1 vs
1); its band equals the gate's.  Every true-ok path therefore costs <= k in
the gate too — the gate can only ADD candidates, never lose one, and the
host re-extension makes the final hit set bit-identical.

The DP is diagonal-banded: D[c, d] tracks dp[p][p + d - band] for
d in [0, 2*band], vectorized over candidates, with the accept-table lookup
as a broadcast shift+and over bit-packed accept masks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


class GateTables:
    """Per-seed-id gate metadata (host-built once per engine run).

    ``accept[s, j, c]`` — extension-pattern position j of seed id s accepts
    text code c (for rmatch seeds the extension pattern is REVERSED so the
    DP walks the backward text window forward).  ``glen[s]`` — extension
    length; ``gdir[s]`` — +1 lmatch (window reads forward from the anchor
    = seed END) / -1 rmatch (window reads backward from
    ``anchor - goff - 1``, i.e. just left of the seed, where
    ``goff[s]`` = the matched seed's length — Extender.rmatch's geomB).
    ``goff`` is folded into ``gdir``'s magnitude (one fewer device
    array): gdir = +1 or -(1 + goff).
    """

    def __init__(self, accept: np.ndarray, glen: np.ndarray,
                 gdir: np.ndarray, goff: np.ndarray, k: int, band: int):
        S, Lg, alpha = accept.shape
        # BIT-PACKED accept: bits[s, p] bit c == position p accepts code c.
        # The DP lookup is then a broadcast shift+and over the window codes
        # (pure elementwise) instead of a per-candidate table gather or batched
        # one-hot matmul.  Code ``alpha`` (= bit position alpha, never set)
        # is the sentinel for out-of-range window slots.
        if alpha >= 30:
            raise NotImplementedError(
                f"gate accept alphabet {alpha} exceeds the int32 bit pack")
        bits = np.zeros((S, Lg), np.int32)
        for c in range(alpha):
            bits |= accept[:, :, c].astype(np.int32) << c
        self.bits_np = bits
        self.glen_np = glen.astype(np.int32)
        self.dir_np = np.asarray(gdir, np.int32)
        self.bits = jnp.asarray(bits)
        self.glen = jnp.asarray(glen.astype(np.int32))
        gd = np.where(np.asarray(gdir) > 0, 1,
                      -(1 + np.asarray(goff))).astype(np.int32)
        self.gdir = jnp.asarray(gd)
        self.Lg = Lg
        self.alpha = alpha
        self.k = k
        self.band = band

    @classmethod
    def from_seed_meta(cls, db, ext_pats, dirs, offs, k: int, band: int,
                       wc: bool, textn: bool):
        """Build accept tables from extension pattern STRINGS, matching
        the true DP's accept test (equal, or IUPAC-compatible in wc mode
        with the text-N rule) over the database alphabet.  ``offs[s]`` is
        the matched seed's length for rmatch seeds (0 for lmatch): the
        backward window starts that many positions left of the anchor."""
        from ..utils.iupac import compat_matrix

        alpha = db.alphabet_size
        S = len(ext_pats)
        Lg = max((len(p) for p in ext_pats), default=1) or 1
        accept = np.zeros((S, Lg, alpha), dtype=bool)
        compat = compat_matrix() if wc else None
        chars = [db.ch(c) for c in range(alpha)]
        for s, pat in enumerate(ext_pats):
            p = pat if dirs[s] > 0 else pat[::-1]
            for j, pc in enumerate(p):
                for c, tc in enumerate(chars):
                    if tc == pc:
                        accept[s, j, c] = True
                    elif (wc and compat[ord(tc), ord(pc)]
                          and (textn or tc != "N")):
                        accept[s, j, c] = True
        glen = np.fromiter((len(p) for p in ext_pats), np.int32, S)
        return cls(accept, glen, np.asarray(dirs, np.int32),
                   np.asarray(offs, np.int32), k, band)


@functools.partial(
    jax.jit, static_argnames=("Lg", "k", "band", "indels", "n"))
def _gate_ok(codes, anchors, sids, bits, glen, gdir, *,
             Lg: int, k: int, band: int, indels: bool, n: int):
    """ok [C] bool — the banded anchored edit distance of each candidate's
    extension pattern is <= k (superset of the true extension's ok)."""
    C = anchors.shape[0]
    Wg = Lg + band
    j = jax.lax.broadcasted_iota(jnp.int32, (1, Wg), 1)
    anchors = anchors.astype(jnp.int32)
    dirc = gdir[sids][:, None]  # [C, 1]; <0 encodes -(1 + seed offset)
    idx = anchors[:, None] + jnp.where(dirc > 0, j, dirc - j)
    inrange = (idx >= 0) & (idx < n)
    w = codes[jnp.clip(idx, 0, n - 1)].astype(jnp.int32)
    # out-of-range slots read the never-set sentinel bit (bit 30)
    w = jnp.where(inrange, w, 30)
    # ACC[c, p, t] = bit w[c, t] of bits[sid, p]: a broadcast shift+and
    # (pure elementwise; no per-candidate gather or batched matmul)
    bits_c = bits[sids]  # [C, Lg] int32
    ACC = ((jax.lax.shift_right_logical(
        bits_c[:, :, None], w[:, None, :])) & 1) > 0  # [C, Lg, Wg]
    INF = np.int32(k + 1)
    glen_c = glen[sids]
    res = jnp.where(glen_c == 0, 0, INF).astype(jnp.int32)
    # D[c, d] = dp[p][p + d - band], saturated at k+1
    D = jnp.full((C, 2 * band + 1), INF, jnp.int32)
    if indels:
        # dp[0][t] = t for t in [0, band] (gate gap cost 1 <= true gapc)
        init = [min(max(d - band, 0) if d >= band else k + 1, k + 1)
                for d in range(2 * band + 1)]
        D = jnp.broadcast_to(
            jnp.asarray(init, jnp.int32)[None, :], (C, 2 * band + 1))
    else:
        D = D.at[:, band].set(0) if band else jnp.zeros((C, 1), jnp.int32)
    for p in range(1, Lg + 1):
        cols = []
        prev_col = None
        for d in range(2 * band + 1):
            tpos = p + d - band
            if tpos == 0 and indels and d + 1 <= 2 * band:
                # leading-deletion column: dp[p][0] = p (text untouched)
                v = jnp.minimum(D[:, d + 1] + 1, INF)
            elif tpos < 1 or tpos > Wg:
                v = jnp.full((C,), INF, jnp.int32)
            else:
                sub = jnp.where(ACC[:, p - 1, tpos - 1], 0, 1)
                v = D[:, d] + sub
                if indels:
                    if d + 1 <= 2 * band:
                        v = jnp.minimum(v, D[:, d + 1] + 1)  # deletion
                    if prev_col is not None:
                        v = jnp.minimum(v, prev_col + 1)  # insertion
                v = jnp.minimum(v, INF)
            cols.append(v)
            prev_col = v
        D = jnp.stack(cols, axis=1)
        rowmin = jnp.min(D, axis=1)
        res = jnp.where(glen_c == p, rowmin, res)
    return res <= k


class ExtendGate:
    """Callable gate over candidate arrays: ``gate(codes_dev, anchors,
    sids) -> ok`` (device bool array).  ``codes_dev`` is the flat code
    array already resident on device."""

    def __init__(self, tables: GateTables, indels: bool):
        self.t = tables
        self.indels = indels

    def __call__(self, codes_dev, anchors, sids):
        t = self.t
        return _gate_ok(
            codes_dev, jnp.asarray(anchors), jnp.asarray(sids),
            t.bits, t.glen, t.gdir,
            Lg=t.Lg, k=t.k, band=t.band, indels=self.indels,
            n=int(codes_dev.shape[0]),
        )
