"""Multi-device position sharding for the scan pipelines.

The parallelism the reference never had (SURVEY §2f): the flat code array
is sharded along the position axis across a 1-D device mesh, each shard
scans its slice plus a static halo (so every window is owned by exactly
one shard — the one containing its start), the pattern tables are
replicated to every device, and per-pattern hit counts are reduced with
``jax.lax.psum``.  On a multi-GPU host the cards are joined all to all by
NVLink and XLA hands ``psum`` / ``all_gather`` to NCCL.  A hit belongs to
the shard containing its window start; the halo guarantees no window is
missed and none is double-counted.

This mirrors the only scaling hooks the reference has — ``allvall``'s
chunked block decomposition merged by ``allvall_merge`` and the
batch-boundary deferral in every ``find_patterns`` caller
(filter_bitvec.cc:118-121) — as static SPMD sharding instead of manual
file-level chunking.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis,))


def _devcount_cache_path():
    from .devcache import devcount_cache_path

    return devcount_cache_path()


def _backend_initialized() -> bool:
    """True when some jax backend is ALREADY live in this process —
    probed without initializing one (the init_distributed pattern:
    jax._src state, never the public API, which would init)."""
    try:
        from jax._src import xla_bridge as _xb

        return bool(_xb._backends)
    except Exception:
        return False


def auto_mesh(axis: str = "data") -> Mesh | None:
    """The data-parallel mesh the CLI tools scan over, or ``None`` for the
    single-device path.

    - ``SAT_MESH=N`` (N > 1): the first N devices — any backend, including
      the virtual CPU mesh tests force (the 1≡N CLI parity tests).
    - ``SAT_MESH`` unset / ``auto``: all devices when more than one
      accelerator is attached (a multi-GPU host auto-shards; a CPU host
      with forced virtual devices does NOT silently change the CLI path).
    - ``SAT_MESH=0`` or ``1``: disabled.

    Auto mode caches the device COUNT on disk (per host + platform env):
    on a known single-device machine the one-shot CLI then skips backend
    initialization entirely.  A stale cache re-probes in the background
    only from processes whose backend is already live (initializing one
    on a daemon thread aborts short-lived processes at exit); a topology
    change therefore costs at most a few unsharded runs until a
    device-using process refreshes the count.  A backend that fails to
    start raises: a card that cannot be reached is an error, not a
    single-device host.
    """
    import os

    spec = os.environ.get("SAT_MESH", "auto").strip().lower()
    if spec in ("0", "1", "off", "none"):
        return None
    if spec in ("", "auto"):
        path = _devcount_cache_path()
        cached = None
        try:
            with open(path) as f:
                cached = int(f.read().strip())
        except (OSError, ValueError):
            pass

        def refresh():
            try:
                with open(path, "w") as f:
                    f.write(str(len(jax.devices())))
            except OSError:
                pass

        if cached == 1:
            import time

            try:  # re-probe only a stale cache
                stale = (time.time() - os.path.getmtime(path)) > 600
            except OSError:
                stale = True
            # ... and ONLY when this process already initialized the
            # backend: a daemon thread mid-backend-init when a
            # short-lived CLI exits aborts the whole process (pthread
            # teardown inside native init -> std::terminate).  A stale
            # cache refreshes on the next device-using run instead.
            if stale and _backend_initialized():
                import threading

                threading.Thread(target=refresh, daemon=True).start()
            elif stale:
                # one-shot posture: auto_mesh runs at model build,
                # BEFORE anything initializes the backend, so the
                # branch above never fires and a 1 -> N topology change
                # would stick at 1 forever.  Refresh at process EXIT
                # instead, only if the run ended up initializing the
                # backend (then jax.devices() is an instant lookup,
                # and atexit runs on the main thread — none of the
                # daemon-init teardown aborts).
                import atexit

                def _exit_refresh():
                    if _backend_initialized():
                        try:
                            n = len(jax.devices())
                            if n >= 1:
                                with open(path, "w") as f:
                                    f.write(str(n))
                        except Exception:
                            pass

                atexit.register(_exit_refresh)
            return None
        devices = jax.devices()
        refresh()
        if len(devices) > 1 and devices[0].platform != "cpu":
            return make_mesh(devices, axis)
        return None
    devices = jax.devices()
    n = int(spec)
    if n <= 1:
        return None
    if len(devices) < n:
        raise SystemExit(
            f"SAT_MESH={n} but only {len(devices)} devices visible")
    return make_mesh(devices[:n], axis)


def shard_codes(codes: np.ndarray, mesh: Mesh, halo: int,
                eos_code: int, axis: str = "data", left: int = 0):
    """Pad codes to a multiple of the mesh size and build the per-shard
    [n_shards, left + shard + halo] uint8 overlapped layout: row i covers
    positions [i*shard - left, (i+1)*shard + halo), EOS outside the array
    (255, a code nothing accepts, when there is no EOS class).  Halos are
    materialized by overlapping slices at load time — no runtime
    communication."""
    n_dev = mesh.devices.size
    n = len(codes)
    shard = max(-(-n // n_dev), 1)
    fill = eos_code if eos_code >= 0 else 255
    padded = np.full(left + n_dev * shard + halo, fill, dtype=np.uint8)
    padded[left : left + n] = codes
    rows = np.lib.stride_tricks.sliding_window_view(
        padded, left + shard + halo)[::shard][:n_dev]
    sharding = NamedSharding(mesh, P(axis, None))
    return jax.device_put(np.ascontiguousarray(rows), sharding), shard


@functools.partial(
    jax.jit, static_argnames=("alpha", "mesh", "axis")
)
def sharded_scan_counts(shards, weights, thresholds, lengths, alpha,
                        mesh, axis: str = "data"):
    """All-shard exact/k-mismatch scan returning replicated per-pattern hit
    counts [P] (the ``patcount`` reduction, primer_match.cc:1236-1247, as a
    psum over the mesh)."""

    def per_shard(codes_block, weights, thresholds, lengths):
        codes = codes_block[0]
        Lmax = weights.shape[0]
        B = codes.shape[0] - Lmax + 1
        onehot = jax.nn.one_hot(codes, alpha, dtype=jnp.bfloat16)

        def step(j, acc):
            window = jax.lax.dynamic_slice_in_dim(onehot, j, B, axis=0)
            return acc + jnp.dot(
                window, weights[j], preferred_element_type=jnp.float32
            )

        out = jax.lax.fori_loop(
            0, Lmax, step, jnp.zeros((B, weights.shape[2]), jnp.float32)
        )
        hit = out >= thresholds[None, :]
        counts = jnp.sum(hit, axis=0, dtype=jnp.int32)
        return jax.lax.psum(counts, axis)[None]

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P(), P()),
        out_specs=P(axis, None),
        check_vma=False,
    )(shards, weights, thresholds, lengths)


@functools.partial(
    jax.jit, static_argnames=("alpha", "mesh", "axis", "cap")
)
def sharded_block_hits(shards, weights, thresholds, lengths, alpha,
                       mesh, axis: str = "data", cap: int = 4096):
    """All-shard XLA block scan returning the REPLICATED global hit list.

    Each shard extracts its local (window-start, pattern) hits into a
    fixed-capacity buffer (overflow detectable via the returned counts),
    rebases starts to global coordinates, and the lists ride one
    ``all_gather``.  Returns (counts [n_dev], starts [n_dev, cap], pids
    [n_dev, cap]) replicated on every device; unused slots hold -1.  The
    deterministic global order is the position-major sort of the
    concatenation (shards own disjoint start ranges, so concatenation
    order == shard order == position order)."""

    def per_shard(codes_block, weights, thresholds, lengths):
        codes = codes_block[0]
        Lmax = weights.shape[0]
        P = weights.shape[2]
        B = codes.shape[0] - Lmax + 1
        onehot = jax.nn.one_hot(codes, alpha, dtype=jnp.bfloat16)

        def step(j, acc):
            window = jax.lax.dynamic_slice_in_dim(onehot, j, B, axis=0)
            return acc + jnp.dot(
                window, weights[j], preferred_element_type=jnp.float32
            )

        out = jax.lax.fori_loop(
            0, Lmax, step, jnp.zeros((B, weights.shape[2]), jnp.float32)
        )
        hit = out >= thresholds[None, :]
        flat = hit.reshape(-1)
        count = jnp.sum(flat, dtype=jnp.int32)
        (idx,) = jnp.nonzero(flat, size=cap, fill_value=flat.shape[0])
        valid = idx < flat.shape[0]
        base = jax.lax.axis_index(axis).astype(jnp.int32) * B
        starts = jnp.where(valid, idx // P + base, -1).astype(jnp.int32)
        pids = jnp.where(valid, idx % P, -1).astype(jnp.int32)
        return (
            jax.lax.all_gather(count, axis)[None],
            jax.lax.all_gather(starts, axis)[None],
            jax.lax.all_gather(pids, axis)[None],
        )

    counts, starts, pids = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P(), P()),
        out_specs=(P(axis, None), P(axis, None, None), P(axis, None, None)),
        check_vma=False,
    )(shards, weights, thresholds, lengths)
    return counts[0], starts[0], pids[0]


def sharded_scan_hits(scanner, codes: np.ndarray, mesh: Mesh,
                      axis: str = "data"):
    """The fused scan pipeline, data-parallel over a device mesh.

    Each shard runs the full single-device pipeline
    (:func:`..ops.microhit.scan_hits`: microhit filter -> compaction ->
    exact rescore -> packed hit row) on its position slice plus a static
    right halo of ``Lmax - 1 + k``; the tiny packed rows ride ONE
    ``all_gather``.  A window is owned by the shard containing its start,
    so decoding each shard's row with ``n = shard_len`` drops
    halo-started duplicates and concatenating in shard order yields the
    position-major global hit list.

    Host-side overflow handling matches the single-device path: if any
    shard's true counts exceed the caps, the caps grow (stickily, on the
    scanner) and the sharded call reruns — correctness never depends on
    capacity.  Yields (end, pid, mism) tuples in global coordinates."""
    from ..ops.microhit import scan_hits

    t = scanner.tables
    bm = scanner._bitmode_nomesh()
    if bm is not None:
        # bit-plane / exact class-encode filter (ConvScanner.
        # _bitplane_mode): the LUT recode runs host-side BEFORE
        # sharding, halos fill with the recoded EOS stand-in, and each
        # shard scans the narrow bit weights
        W, thr, classes = bm["W"], bm["thr"], bm["classes"]
        alpha_r, eos_r, wconv = bm["alpha_r"], bm["eos_r"], bm["wconv"]
        codes = _recode_host(codes, bm["lut"])
    else:
        W, thr, classes = scanner._filter_weights()
        alpha_r, eos_r, wconv = t.alpha, t.eos_code, scanner.weights
    halo = t.Lmax - 1 + scanner.k
    shards, shard_len = shard_codes(
        np.asarray(codes), mesh, halo, eos_r, axis)

    while True:
        cap_mb, hit_cap = scanner._cap_mb, scanner._hit_cap

        def per_shard(codes_block, W, thr, wconv, thresholds, lengths):
            row = scan_hits(
                codes_block[0], W, thr, wconv, thresholds, lengths,
                classes=classes, alpha=alpha_r, Lmax=t.Lmax,
                eos_code=eos_r, MB=scanner._MB, cap_mb=cap_mb,
                hit_cap=hit_cap,
            )
            return jax.lax.all_gather(row, axis)[None]

        rows = jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(), P(), P(), P(), P()),
            out_specs=P(axis, None, None),
            check_vma=False,
        )(shards, W, thr, wconv, scanner.thresholds,
          scanner.lengths_dev)
        rows = np.asarray(jax.device_get(rows[0]))  # [n_dev, rowlen]
        if (rows[:, 0] <= cap_mb).all() and (rows[:, 1] <= hit_cap).all():
            break
        # a shard overflowed: grow the caps past the worst observed true
        # counts and rerun (sticky, same policy as ConvScanner._redispatch)
        mbt = max(int(rows[:, 0].max()), 1)
        ht = max(int(rows[:, 1].max()), 1)
        scanner._cap_mb = max(cap_mb, 1 << (mbt - 1).bit_length())
        scanner._hit_cap = max(hit_cap, 1 << (ht - 1).bit_length())

    def gen():
        for i in range(rows.shape[0]):
            base = i * shard_len
            for end, pid, mism in scanner._decode_packed(
                    rows[i], None, shard_len, (cap_mb, hit_cap)):
                yield end + base, pid, mism

    return gen()


_RECODE_CACHE: dict = {}


def _recode_host(codes, lut_dev):
    """LUT-recoded uint8 host copy for the bit-plane modes, via
    ``bytes.translate`` (memcpy speed, unlike a numpy fancy-index
    gather), cached by (codes, lut) identity so the resident serving
    stream recodes once per database, not once per dispatched run."""
    import weakref

    key = (id(codes), id(lut_dev))
    ent = _RECODE_CACHE.get(key)
    if ent is not None and ent[0]() is codes and ent[2] is lut_dev:
        return ent[1]
    arr = np.ascontiguousarray(np.asarray(codes, np.uint8))
    tbl = bytes(np.asarray(lut_dev, np.uint8))
    out = np.frombuffer(arr.tobytes().translate(tbl), np.uint8)
    try:
        ref = weakref.ref(codes)
        weakref.finalize(codes, _RECODE_CACHE.pop, key, None)
        _RECODE_CACHE[key] = (ref, out, lut_dev)
    except TypeError:
        pass
    return out


_SHARDS_CACHE: dict = {}


def _gated_shards(codes, scanner, gt, mesh, axis: str):
    """Device-resident overlapped shard layout for the gated pipeline,
    with a halo on BOTH sides: the extension gate reads up to ``Lg +
    band`` codes past either end of a seed window, so a shard needs
    ``Lmax + Lg + band + 1`` codes of context each way to gate its own
    candidates exactly as one device would.  Cached by host-array
    identity: the serving stream re-dispatches the same resident
    database every run.  Returns (shards, shard_len, halo)."""
    import weakref

    t = scanner.tables
    halo = t.Lmax + gt.Lg + gt.band + 1
    key = (id(codes), id(mesh), axis, halo, t.eos_code)
    ent = _SHARDS_CACHE.get(key)
    # the mesh must be identity-checked too (held strongly in the
    # entry): a rebuilt mesh can land on a dead mesh's recycled id
    # while the resident codes stay alive
    if ent is not None and ent[0]() is codes and ent[3] is mesh:
        return ent[1], ent[2], halo
    shards, shard_len = shard_codes(np.asarray(codes), mesh, halo,
                                    t.eos_code, axis, left=halo)
    try:
        ref = weakref.ref(codes)
        weakref.finalize(codes, _SHARDS_CACHE.pop, key, None)
        _SHARDS_CACHE[key] = (ref, shards, shard_len, mesh)
    except TypeError:
        pass
    return shards, shard_len, halo


def _gated_fn(scanner, gt, indels: bool, k: int, mesh, axis: str, caps):
    """Jitted shard_map of :func:`..ops.microhit.scan_gated` for one
    (gate, caps) config, cached on the scanner."""
    cache = getattr(scanner, "_gated_fn_c", None)
    if cache is None:
        cache = scanner._gated_fn_c = {}
    key = (id(gt), indels, k, id(mesh), axis, caps)
    fn = cache.get(key)
    if fn is not None:
        return fn
    from ..ops.microhit import pos_exact_ok, scan_gated

    t = scanner.tables
    exact_pos = pos_exact_ok(t, scanner.k)
    W, thr, classes = (scanner._filter_weights_exact() if exact_pos
                       else scanner._filter_weights())

    def per_shard(codes_block, W, thr, wconv, thresholds, lengths, bits,
                  glen, gdir):
        row = scan_gated(
            codes_block[0], W, thr, wconv, thresholds, lengths, bits,
            glen, gdir, classes=classes, alpha=t.alpha, Lmax=t.Lmax,
            eos_code=t.eos_code, MB=scanner._MB, cap_mb=caps[0],
            hit_cap=caps[1], multi_cap=caps[2], surv_cap=caps[3],
            Lg=gt.Lg, kk=k, band=gt.band, indels=indels,
            exact_pos=exact_pos)
        return jax.lax.all_gather(row, axis)[None]

    jfn = jax.jit(jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(axis, None),) + (P(),) * 8,
        out_specs=P(axis, None, None),
        check_vma=False,
    ))
    args = (W, thr, scanner.weights, scanner.thresholds,
            scanner.lengths_dev, gt.bits, gt.glen, gt.gdir)

    def fn(shards):
        return jfn(shards, *args)[0]

    cache[key] = fn
    return fn


def sharded_scan_gated(scanner, gt, indels: bool, k: int,
                       codes: np.ndarray, mesh: Mesh, axis: str = "data"):
    """The fused k>0 gated pipeline (seed filter + extension gate,
    :func:`..ops.microhit.scan_gated`), data-parallel over a device
    mesh: every shard runs it on its position slice plus halos on both
    sides, and the small packed rows ride one ``all_gather``.  A
    candidate is owned by the shard containing its window START; the
    host decodes each shard's row, drops candidates and escapes that
    start in a halo, and rebases.  Output contract identical to
    ConvScanner.scan_gated — (anchors, sids, multi) in global
    coordinates."""
    shards, shard_len, halo = _gated_shards(codes, scanner, gt, mesh, axis)
    cls = type(scanner)
    while True:
        caps = (scanner._gcap_mb, scanner._ghit_cap, scanner._gmulti_cap,
                scanner._gsurv_cap)
        rows = np.asarray(jax.device_get(
            _gated_fn(scanner, gt, indels, k, mesh, axis, caps)(shards)))
        over = [rows[:, i].max() > caps[i] for i in range(4)]
        if not any(over):
            break
        cls._gcap_mb, cls._ghit_cap, cls._gmulti_cap, cls._gsurv_cap = (
            max(c, 1 << (max(int(rows[:, i].max()), 1) - 1).bit_length())
            for i, c in enumerate(caps))
    lengths = scanner.tables.lengths
    anchors_l, sids_l, multi_l = [], [], []
    for i in range(rows.shape[0]):
        a, s, mu = scanner._gated_unpack(rows[i], caps)
        st = a - lengths[s]
        own = (st >= halo) & (st < halo + shard_len)
        base = i * shard_len - halo
        anchors_l.append(a[own] + base)
        sids_l.append(s[own])
        mown = (mu >= halo) & (mu < halo + shard_len)
        multi_l.append(mu[mown] + base)
    return (np.concatenate(anchors_l), np.concatenate(sids_l),
            np.concatenate(multi_l))


def sharded_sellers_scan(scanner, codes: np.ndarray, mesh: Mesh,
                         axis: str = "data"):
    """The k-edit Sellers candidate scan (ops.sellers), data-parallel over
    the mesh: each shard runs the row DP over its position slice plus a
    static LEFT halo of ``Lmax + k`` (a candidate boundary belongs to the
    shard containing it; the halo supplies every window that can reach
    it), and the packed candidate rows ride one ``all_gather``.

    Yields (end, pid, mindist) per shard in (end, pattern) order — the
    same blockwise-sorted contract as ``SellersScanner.scan`` (the filter
    engine, its only consumer, re-sorts globally either way)."""
    from ..ops.sellers import _sellers_block

    t = scanner.tables
    k, indels = scanner.k, scanner.indels
    halo = t.Lmax + k
    n_dev = mesh.devices.size
    n = len(codes)
    shard = -(-n // n_dev)
    W = shard + halo
    lay = np.full((n_dev, W), t.eos_code, dtype=np.uint8)
    padded = np.full(n_dev * shard + halo, t.eos_code, dtype=np.uint8)
    padded[halo : halo + n] = codes
    for i in range(n_dev):
        lay[i] = padded[i * shard : i * shard + W]
    shards = jax.device_put(lay, NamedSharding(mesh, P(axis, None)))

    while True:
        cap = scanner.cap

        def per_shard(codes_block, match, lengths):
            row = _sellers_block.__wrapped__(
                codes_block[0], match, lengths, t.eos_code, k, indels, cap)
            return jax.lax.all_gather(row, axis)[None]

        rows = jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(axis, None), P(), P()),
            out_specs=P(axis, None, None),
            check_vma=False,
        )(shards, scanner.match, scanner.lengths_dev)
        rows = np.asarray(jax.device_get(rows[0]))  # [n_dev, 1 + 2*cap]
        if (rows[:, 0] <= cap).all():
            break
        scanner.cap = 1 << (int(rows[:, 0].max()) - 1).bit_length()

    for d in range(n_dev):
        count = int(rows[d, 0])
        if count == 0:
            continue
        idx = rows[d, 1 : 1 + count].astype(np.int64)
        dist = rows[d, 1 + cap : 1 + cap + count]
        pos = idx % W
        pid = idx // W
        keep = (pos >= halo) & (d * shard + (pos - halo) < n)
        pos, pid, dist = pos[keep], pid[keep], dist[keep]
        ends = d * shard + (pos - halo) + 1
        order = np.lexsort((pid, ends))
        for e, p, dd in zip(ends[order], pid[order], dist[order]):
            yield int(e), int(p), int(dd)


def _bind_sharded_dispatch(scanner, mesh, axis, caps):
    """One jitted shard_map'd fused-scan dispatch for a (mesh, caps)
    config.  Each shard's packed result row STAYS on its own device
    (``out_specs=P(axis, None)``) — unlike the one-shot
    :func:`sharded_scan_hits` there is no all_gather, because the
    stream's consumer is the host fetch, not the other devices."""
    from ..ops.microhit import scan_hits

    t = scanner.tables
    bm = scanner._bitmode_nomesh()
    if bm is not None:
        # bit-plane / exact class-encode weights; the stream's dispatch
        # applies the LUT recode before shard_codes (see
        # sharded_scan_stream)
        W, thr, classes = bm["W"], bm["thr"], bm["classes"]
        alpha_r, eos_r, wconv = bm["alpha_r"], bm["eos_r"], bm["wconv"]
    else:
        W, thr, classes = scanner._filter_weights()
        alpha_r, eos_r, wconv = t.alpha, t.eos_code, scanner.weights
    cap_mb, hit_cap = caps

    def per_shard(codes_block, W, thr, wconv, thresholds, lengths):
        return scan_hits(
            codes_block[0], W, thr, wconv, thresholds, lengths,
            classes=classes, alpha=alpha_r, Lmax=t.Lmax,
            eos_code=eos_r, MB=scanner._MB, cap_mb=cap_mb,
            hit_cap=hit_cap,
        )[None]

    jfn = jax.jit(jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(axis, None), P(), P(), P(), P(), P()),
        out_specs=P(axis, None),
        check_vma=False,
    ))

    def fn(shards_dev):
        return jfn(shards_dev, W, thr, wconv,
                   scanner.thresholds, scanner.lengths_dev)

    return fn


def sharded_scan_stream(scanner, blocks, mesh, axis: str = "data",
                        depth: int = 32):
    """Multi-chip PIPELINED scan over an iterator of flat code arrays —
    the sharded analog of ``ConvScanner.scan_stream`` (SURVEY §2f
    "pipelined scan" row).

    Every block is position-sharded over the mesh (static halo of
    ``Lmax - 1 + k``; a window is owned by the shard containing its
    start) and dispatched WITHOUT sync, so all chips scan concurrently
    while later blocks upload; per-shard packed result rows are fetched
    on a background thread, overlapping the round-trip with the next
    dispatches.  Overflowed blocks rerun whole with stickily grown caps
    (same convergence policy as the single-chip paths) — correctness
    never depends on capacity.

    Yields ``(block_index, hits_list)`` in block order; hits are
    (end, pid, mism) in block-local coordinates, in the single-chip
    stream's (window-start, pattern) order.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    t = scanner.tables
    halo = t.Lmax - 1 + scanner.k
    pool = ThreadPoolExecutor(max_workers=1)
    cache: dict = {}

    bm = scanner._bitmode_nomesh()
    eos_fill = t.eos_code if bm is None else bm["eos_r"]

    def dispatch(codes):
        caps = (scanner._cap_mb, scanner._hit_cap)
        fn = cache.get(caps)
        if fn is None:
            fn = cache[caps] = _bind_sharded_dispatch(
                scanner, mesh, axis, caps)
        arr = np.asarray(codes)
        if bm is not None:
            arr = _recode_host(codes, bm["lut"])
        shards, shard_len = shard_codes(arr, mesh, halo, eos_fill, axis)
        rows = fn(shards)
        return rows, shard_len, caps

    def decode(codes, shard_len, caps, fetched):
        while (fetched[:, 0] > caps[0]).any() \
                or (fetched[:, 1] > caps[1]).any():
            scanner._cap_mb = max(
                scanner._cap_mb,
                1 << (max(int(fetched[:, 0].max()), 1) - 1).bit_length())
            scanner._hit_cap = max(
                scanner._hit_cap,
                1 << (max(int(fetched[:, 1].max()), 1) - 1).bit_length())
            rows, shard_len, caps = dispatch(codes)
            fetched = np.asarray(jax.device_get(rows))
        out = []
        for d in range(fetched.shape[0]):
            base = d * shard_len
            for end, pid, mism in scanner._decode_packed(
                    fetched[d], None, shard_len, caps):
                out.append((end + base, pid, mism))
        return out

    def start_fetch(item):
        i, codes, rows, shard_len, caps = item
        fut = pool.submit(lambda r=rows: np.asarray(jax.device_get(r)))
        return (i, codes, shard_len, caps, fut)

    pending: deque = deque()
    inflight = None
    try:
        for i, codes in enumerate(blocks):
            pending.append((i, codes) + dispatch(codes))
            if len(pending) >= depth:
                if inflight is not None:
                    i0, c0, s0, caps0, fut = inflight
                    yield i0, decode(c0, s0, caps0, fut.result())
                inflight = start_fetch(pending.popleft())
        while inflight is not None or pending:
            if inflight is not None:
                i0, c0, s0, caps0, fut = inflight
                yield i0, decode(c0, s0, caps0, fut.result())
                inflight = None
            if pending:
                inflight = start_fetch(pending.popleft())
    finally:
        pool.shutdown(wait=False)
