"""Row-vectorized Sellers semi-global DP: the k-edit candidate scan.

The indel-capable analog of the reference's Wu-Manber bitvector scan
(``shift_and_inexact.cc:249-350``).  For every text boundary ``b`` and
pattern ``p`` it computes

    mindist(b, p) = min edits to align p against some text substring
                    ending at b   (capped at k+1)

with the reference's EOS gating: all error transitions are disallowed on an
EOS character, so matches never straddle entry boundaries.  Identical
candidate sets to the reference's bitvectors (a bit set in row ``l`` there
means "prefix matches with <= l errors"; the minimal such ``l`` *is* the
Sellers distance).

Device mapping: the pattern axis is a short sequential loop (Lmax rows);
each row is elementwise work over the whole [P, W] block, which XLA fuses.
The insertion recurrence (a slope-1 running min along the text) exploits
the k+1 value cap: a chain longer than k saturates, so the running min
collapses to a k-term shifted min — O(k) shifted adds instead of an
associative scan.
"""

from __future__ import annotations

import numpy as np

from ..utils import lazyjax
from ..utils.lazyjax import LazyModule, lazy_jit

# jax bindings deferred to first device-path use: host-served one-shot
# runs (native Sellers rows) never import jax.
jax = LazyModule("jax", "jax", globals())
jnp = LazyModule("jax.numpy", "jnp", globals())


@lazy_jit(static_argnames=("eos", "k", "indels", "cap"))
def _sellers_block(codes, match, lengths, eos, k, indels, cap):
    """codes: [W] uint8 (left halo Lmax+k); match: [Lmax, P, alpha] bool;
    lengths: [P] int32; eos: the EOS alphabet code.

    Returns ONE packed int32 array [1 + 2*cap]: (count, flat_idx...,
    dist...) over the [P, W] grid of per-boundary min distances
    (boundary b = i + 1), packed so one device-to-host copy returns it.

    The non-EOS run length ``nrun`` is derived on device (a max-scan of
    EOS positions).  Within-chunk truncation at the left edge is safe:
    candidates in the halo are discarded by the caller, and kept
    positions (>= halo >= k in) only ever test ``nrun >= t`` for t <= k.
    """
    Lmax, P, alpha = match.shape
    W = codes.shape[0]
    INF = np.int32(k + 1)
    codes = codes.astype(jnp.int32)
    iota = jax.lax.iota(jnp.int32, W)
    last_eos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(codes == eos, iota, -1))
    nrun = iota - last_eos
    # row-invariant masks, hoisted: the per-class one-hot rows (an
    # unrolled broadcast-AND over the tiny static alpha axis fuses into
    # one pass, where a gather from the match row would not) and the
    # EOS / run gates
    eq = codes[None, :] == jax.lax.iota(jnp.int32, alpha)[:, None]  # [A, W]
    at_eos = (nrun == 0)[None, :]
    allowed = [(nrun >= t)[None, :] for t in range(k + 1)]

    def row(j, D):
        # D: [P, W] distances for pattern prefix j
        mrow = match[j]  # [P, alpha]
        ok = jnp.zeros((P, W), bool)
        for c in range(alpha):
            ok = ok | (eq[c][None, :] & mrow[:, c][:, None])
        subc = jnp.where(ok, 0, 1).astype(jnp.int32)
        # EOS: no sub/ins/del; match of a pattern char vs EOS is already
        # impossible (EOS never in a match row), so make diag cost INF there.
        diag_prev = jnp.concatenate(
            [jnp.full((P, 1), INF, jnp.int32), D[:, :-1]], axis=1
        )
        base = jnp.where(at_eos, INF, diag_prev + subc)
        if indels:
            dele = jnp.where(at_eos, INF, D + 1)
            base = jnp.minimum(base, dele)
        base = jnp.minimum(base, INF)
        out = base
        if indels:
            for t in range(1, k + 1):
                shifted = jnp.concatenate(
                    [jnp.full((P, t), INF, jnp.int32), base[:, :-t]], axis=1
                )
                out = jnp.minimum(
                    out, jnp.where(allowed[t], shifted + t, INF)
                )
        out = jnp.minimum(out, INF)
        # rows past a pattern's length are identity (pattern finished)
        active = (j < lengths)[:, None]
        return jnp.where(active, out, D)

    D0 = jnp.zeros((P, W), dtype=jnp.int32)
    D = jax.lax.fori_loop(0, Lmax, row, D0)

    from .compact import _topk_idx

    # two-level compaction along the TEXT axis: compact the occupied
    # boundary columns (almost-empty [W] mask), then the gathered
    # [P, pcap] submatrix — a flat top_k over the whole [P, W] grid costs
    # as much as the DP itself.  Emitted order is (pattern, column-rank),
    # not flat order: the caller lexsorts by (end, pattern) anyway, and
    # the overflow contract holds because count >= occupied columns, so
    # count <= cap implies every occupied column was kept.
    hit = D <= k
    colcnt = jnp.sum(hit, axis=0, dtype=jnp.int32)  # [W]
    count = jnp.sum(colcnt, dtype=jnp.int32)
    pcap = min(cap, W)
    pidx = _topk_idx(colcnt > 0, pcap)  # ascending columns, fill W
    sub = hit[:, jnp.minimum(pidx, W - 1)] & (pidx < W)[None, :]
    sidx = _topk_idx(sub.reshape(-1), cap)  # over [P, pcap] row-major
    svalid = sidx < P * pcap
    cols = pidx[jnp.minimum(sidx % pcap, pcap - 1)]
    idx = jnp.where(svalid, (sidx // pcap) * W + cols, P * W)
    d = jnp.concatenate([D.reshape(-1), jnp.zeros((1,), jnp.int32)])
    return jnp.concatenate([count[None], idx.astype(jnp.int32), d[idx]])


class SellersScanner:
    """Block-streaming k-edit candidate scanner.

    Yields (end_position, pattern_index_0based, mindist) ordered by
    (end, pattern)."""

    def __init__(self, tables, k: int, indels: bool = True,
                 block: int = 1 << 20, cap: int = 1 << 12):
        # cap default: the packed result row is 1 + 2*cap int32, typical
        # blocks carry a few hundred candidates, and overflow retries
        # (geometric growth) cover dense runs
        self.tables = tables
        self.k = k
        self.indels = indels
        self.block = block
        self.cap = cap
        self._dev_c = None  # lazy: construction must not init the backend
        # optional per-block progress callback (pattern_match.h:144-155)
        self.progress = None

    @property
    def match(self):
        # match layout [Lmax, P, alpha] for row-major dynamic indexing
        if self._dev_c is None:
            self._dev_c = (
                jnp.asarray(np.ascontiguousarray(
                    self.tables.match.transpose(1, 0, 2))),
                jnp.asarray(self.tables.lengths),
            )
        return self._dev_c[0]

    @property
    def lengths_dev(self):
        self.match
        return self._dev_c[1]

    # a jax.sharding.Mesh attached by the model layer (parallel.shard.
    # auto_mesh); scans route through the sharded per-shard DP when set
    mesh = None
    # tests: take the device scan (scan_pairs) on any backend
    force_device = False

    _routes_done = None

    def _route(self, msg: str) -> None:
        """Reference-style '-v' route announcement (see
        ConvScanner._route): names the k-edit route actually used."""
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

    # -- native host k-edit machine (one-shot latency path) ------------------

    _host_scanner = None
    # tri-state like ConvScanner.use_host: None = auto (route small/cold
    # scans to the native machine), False = pin the device paths
    use_host = None

    def _host_eligible(self, n: int) -> bool:
        """Route to the native Sellers row machine when fixed device
        costs (compile, upload, round trips) dominate — the one-shot CLI
        posture (select.cc:103-142 strategy-layer spirit)."""
        import os

        if (self.use_host is False or self.force_device
                or self.mesh is not None or not self.indels):
            return False
        if self.use_host is None and (self.k > 4 or n > (1 << 26)):
            return False
        if os.environ.get("SAT_HOST_SCAN", "1") == "0":
            return False
        if self._host_scanner is None:
            from .host_scan import HostSellers

            self._host_scanner = HostSellers(self.tables, self.k)
        return self._host_scanner.available()

    def host_pairs(self, codes: np.ndarray):
        """(ends, pids) via the native machine (caller checked
        :meth:`_host_eligible`)."""
        ends, pids, _ = self._host_scanner.pairs(np.asarray(codes))
        return ends, pids

    # -- device whole-array candidate scan -----------------------------------

    # positions per device block of scan_pairs: a [P, block] int32 DP
    # state row plus its per-row temporaries stays far below the card's
    # memory at P in the hundreds (first choice, not tuned)
    _PAIRS_BLOCK = 1 << 22

    def device_available(self, n: int) -> bool:
        """The whole-array device scan (:meth:`scan_pairs`) serves this
        scan: the GPU, or a test that forced the device route."""
        return bool(self.force_device or lazyjax.on_gpu())

    def scan_pairs_stream(self, blocks):
        """:meth:`scan_pairs` over an iterator of code arrays.  Yields
        (i, ends, pids) in order."""
        for i, codes in enumerate(blocks):
            yield (i,) + self.scan_pairs(codes)

    def scan_pairs(self, codes: np.ndarray):
        """(ends [M] int64, pids [M] int64) — the full Sellers candidate
        set {(b, p): mindist(b, p) <= k}, UNORDERED: the XLA block DP over
        large blocks, dispatched one block ahead of the host decode.
        Candidate set identical to :meth:`scan`'s."""
        self._route("XLA Sellers whole-array scan (Lmax=%d, P=%d, k=%d)"
                    % (self.tables.Lmax, self.tables.P, self.k))
        ends_l, pids_l = [], []
        for ends, pids, _dist in self._block_arrays(
                codes, self._PAIRS_BLOCK):
            ends_l.append(ends)
            pids_l.append(pids)
        if not ends_l:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(ends_l), np.concatenate(pids_l)

    def _block_inputs(self, codes, start, halo, W, n, block):
        t = self.tables
        lo = start - halo
        chunk = np.full(W, t.eos_code, dtype=np.uint8)
        s0 = max(0, lo)
        hi = min(n, start + block)
        chunk[s0 - lo : W - max(0, (start + block) - n)] = codes[s0:hi]
        return lo, jnp.asarray(chunk)

    def _block_arrays(self, codes: np.ndarray, block: int):
        """Pipelined block DP: block i+1 is dispatched before block i's
        results are collected, hiding the host round-trip behind device
        compute.  Yields (ends, pids, dist) arrays per block, each in
        (end, pattern) order."""
        from collections import deque

        t = self.tables
        halo = t.Lmax + self.k
        n = len(codes)
        W = block + halo
        pending = deque()

        def collect(lo, dchunk, res, cap):
            if self.progress:
                self.progress(min(1.0, (lo + halo + block) / n))
            packed = np.asarray(res)
            count = int(packed[0])
            while count > cap:
                cap = 1 << (count - 1).bit_length()
                self.cap = max(self.cap, cap)
                packed = np.asarray(_sellers_block(
                    dchunk, self.match, self.lengths_dev, t.eos_code,
                    self.k, self.indels, cap,
                ))
                count = int(packed[0])
            idx = packed[1 : 1 + count].astype(np.int64)
            dist = packed[1 + cap : 1 + cap + count]
            pos = idx % W  # position within chunk
            pid = idx // W
            keep = pos >= halo  # halo candidates belong to the prior block
            pos, pid, dist = pos[keep], pid[keep], dist[keep]
            ends = lo + pos + 1  # boundary after char
            order = np.lexsort((pid, ends))
            return ends[order], pid[order], dist[order]

        for start in range(0, n, block):
            lo, dchunk = self._block_inputs(codes, start, halo, W, n, block)
            res = _sellers_block(dchunk, self.match, self.lengths_dev,
                                 t.eos_code, self.k, self.indels, self.cap)
            pending.append((lo, dchunk, res, self.cap))
            while len(pending) >= 2:
                yield collect(*pending.popleft())
        while pending:
            yield collect(*pending.popleft())

    def scan(self, codes: np.ndarray):
        """Block scan in (end, pattern) order per block."""
        if self.mesh is not None and self.mesh.devices.size > 1:
            from ..parallel.shard import sharded_sellers_scan

            yield from sharded_sellers_scan(self, codes, self.mesh)
            if self.progress:
                self.progress(1.0)
            return
        # explicit pin only: auto host routing happens at the filter
        # engine (the XLA block DP below stays the parity oracle)
        if self.use_host is True and self._host_eligible(len(codes)):
            self._route("native Sellers row machine (host)")
            ends, pids, dist = self._host_scanner.pairs(np.asarray(codes))
            order = np.lexsort((pids, ends))
            for i in order:
                yield int(ends[i]), int(pids[i]), int(dist[i])
            if self.progress:
                self.progress(1.0)
            return
        t = self.tables
        self._route("XLA Sellers block DP (Lmax=%d, P=%d, k=%d)"
                    % (t.Lmax, t.P, self.k))
        for ends, pids, dist in self._block_arrays(codes, self.block):
            for e, p, d in zip(ends.tolist(), pids.tolist(), dist.tolist()):
                yield e, p, d
