"""Device-side index compaction (the "variable-rate hit emission" primitive).

Every scan pipeline ends with "extract the indices of the set bits of a
huge, almost-empty mask into a fixed-capacity buffer" — the device
stand-in for the reference's incremental hit emission
(``pattern_match.h:105-133``'s find_patterns batches).  ``jnp.nonzero``
lowers to a full-array cumsum + scatter; :func:`compact_mask` instead
ranks set positions with ``lax.top_k`` over descending keys, which
preserves the same ascending-index, first-``cap``-survivors,
``fill = mask.size`` contract.  Which of the two is faster on the GPU
is not measured yet.

For large masks a single ``top_k`` over the whole array is costly, so the
mask is compacted in TWO levels: chunk
the mask, ``top_k`` the (tiny) chunk-occupancy mask, gather the occupied
chunks, and ``top_k`` the gathered ``[cap, chunk]`` submask.  Exactness:
the first ``cap`` set positions span at most ``cap`` distinct chunks and
the first level keeps the first ``min(cap, nchunks)`` occupied chunks in
ascending order, so the composition returns exactly the first ``cap`` set
positions — including in the overflow case (``count > cap``), where the
caller retries with a larger cap anyway.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _topk_idx(mask, cap: int):
    """[cap] int32: first ``cap`` set positions of flat ``mask``,
    ascending, padded with ``mask.size``."""
    n = mask.shape[0]
    keys = jnp.where(mask, n - jax.lax.broadcasted_iota(jnp.int32, (n,), 0),
                     0)
    vals, _ = jax.lax.top_k(keys, min(cap, n))
    idx = jnp.where(vals > 0, n - vals, n).astype(jnp.int32)
    if cap > n:
        idx = jnp.concatenate([idx, jnp.full((cap - n,), n, jnp.int32)])
    return idx


def compact_mask(mask, cap: int, chunk: int | None = None):
    """Indices of the set entries of a flat boolean mask.

    Returns ``(count, idx)`` where ``count`` is the total number of set
    entries (``int32``; caller detects overflow as ``count > cap``) and
    ``idx`` is ``[cap] int32``: the first ``cap`` set positions in
    ascending order, padded with ``mask.size``  — exactly the contract of
    ``jnp.nonzero(mask, size=cap, fill_value=mask.size)``.
    """
    n = mask.shape[0]
    if chunk is None:
        chunk = 128 if n < (1 << 25) else 512
    if cap * 16 >= n > (1 << 16):
        # dense caps: top_k cost grows with k, so the cumsum+scatter
        # lowering of nonzero takes over when cap is a sizable fraction
        # of the mask
        return (jnp.sum(mask, dtype=jnp.int32),
                jnp.nonzero(mask, size=cap, fill_value=n)[0]
                .astype(jnp.int32))
    if n <= (1 << 16) or cap * chunk * 2 >= n:
        return jnp.sum(mask, dtype=jnp.int32), _topk_idx(mask, cap)

    nrows = -(-n // chunk)
    m2 = jnp.pad(mask, (0, nrows * chunk - n)).reshape(nrows, chunk)
    rowcnt = jnp.sum(m2, axis=1, dtype=jnp.int32)
    count = jnp.sum(rowcnt, dtype=jnp.int32)
    rcap = min(cap, nrows)
    ridx = _topk_idx(rowcnt > 0, rcap)
    valid = ridx < nrows
    sub = m2[jnp.minimum(ridx, nrows - 1)] & valid[:, None]
    sidx = _topk_idx(sub.reshape(-1), cap)
    svalid = sidx < rcap * chunk
    rows = ridx[jnp.minimum(sidx // chunk, rcap - 1)]
    idx = jnp.where(svalid, rows * chunk + sidx % chunk, n)
    return count, idx.astype(jnp.int32)
