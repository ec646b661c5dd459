"""Multihost scaling skeleton: jax.distributed bring-up + the 2-D
('host', 'chip') mesh variant of the position-sharded scan.

The reference's only scaling story is manual file-level chunking merged
after the fact (allvall.cc:18-20 block decomposition, fasta_io.t:154-263
flat coordinate space).  This generalization keeps ONE flat coordinate
space and shards it over a 2-D device mesh: the inner 'chip' axis maps
to the cards of one host (joined all to all by NVLink), the outer
'host' axis maps across hosts (the network between machines).  XLA
hands both axes' collectives to NCCL.  Count reductions psum over both
axes; hit gathers ride the chip axis first so the slower cross-host hop
moves only per-host aggregates.

On a single process this compiles and runs unchanged over a virtual
device grid (the dryrun / CI path); on several hosts,
:func:`init_distributed` brings up the jax.distributed runtime first and
``jax.devices()`` spans all hosts.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed() -> tuple[int, int]:
    """Guarded multihost bring-up.  Returns (process_index, process_count).

    Initializes ``jax.distributed`` exactly once when a coordinator is
    configured — via ``SAT_COORDINATOR`` (+ ``SAT_NUM_PROCESSES`` /
    ``SAT_PROCESS_ID``) or the standard JAX service env
    (``JAX_COORDINATOR_ADDRESS``) — and is a no-op for single-process
    runs, so every CLI tool can call it unconditionally at startup.
    """
    coord = os.environ.get("SAT_COORDINATOR") \
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    # probe the service state, NOT jax.process_count(): the latter
    # initializes the XLA backend, after which initialize() refuses
    from jax._src import distributed as _dist

    already = getattr(_dist.global_state, "client", None)
    if coord and already is None:
        nproc = os.environ.get("SAT_NUM_PROCESSES")
        pid = os.environ.get("SAT_PROCESS_ID")
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(nproc) if nproc else None,
            process_id=int(pid) if pid else None,
        )
    return jax.process_index(), jax.process_count()


def make_host_chip_mesh(n_hosts: int | None = None, devices=None) -> Mesh:
    """2-D ('host', 'chip') mesh.  ``n_hosts`` defaults to
    ``jax.process_count()`` (1 in single-process dryruns — pass it
    explicitly to emulate a pod on a virtual device grid)."""
    if devices is None:
        devices = jax.devices()
    if n_hosts is None:
        n_hosts = max(jax.process_count(), 1)
    n = len(devices)
    assert n % n_hosts == 0, (n, n_hosts)
    grid = np.array(devices).reshape(n_hosts, n // n_hosts)
    return Mesh(grid, ("host", "chip"))


def shard_codes_2d(codes: np.ndarray, mesh: Mesh, halo: int, eos_code: int):
    """Position-shard a flat code array over the host x chip grid:
    [H, C, shard + halo] with overlapping static right halos (same
    ownership rule as the 1-D layout — a window belongs to the shard
    containing its start)."""
    H, C = mesh.devices.shape
    n_dev = H * C
    n = len(codes)
    shard = -(-n // n_dev)
    padded = np.full(n_dev * shard + halo, eos_code, dtype=np.int32)
    padded[:n] = codes
    out = np.empty((n_dev, shard + halo), dtype=np.int32)
    for i in range(n_dev):
        out[i] = padded[i * shard : i * shard + shard + halo]
    out = out.reshape(H, C, shard + halo)
    sharding = NamedSharding(mesh, P("host", "chip", None))
    if jax.process_count() > 1:
        # real multi-process runs: every process holds the full flat
        # array (the reference's one-flat-coordinate-space model), each
        # contributes only its addressable shards
        arr = jax.make_array_from_callback(
            out.shape, sharding, lambda idx: out[idx])
        return arr, shard
    return jax.device_put(out, sharding), shard


@functools.partial(jax.jit, static_argnames=("alpha", "mesh"))
def sharded_scan_counts_2d(shards, weights, thresholds, lengths, alpha,
                           mesh):
    """Replicated per-pattern hit counts [P] over the 2-D mesh: each
    shard scans its slice, counts psum over 'chip' then 'host' — only
    the [P]-sized partial rides the cross-host hop."""

    def per_shard(codes_block, weights, thresholds, lengths):
        codes = codes_block[0, 0]
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
        counts = jnp.sum(out >= thresholds[None, :], axis=0, dtype=jnp.int32)
        counts = jax.lax.psum(counts, "chip")
        counts = jax.lax.psum(counts, "host")
        return counts[None, None]

    return jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P("host", "chip", None), P(), P(), P()),
        out_specs=P("host", "chip", None),
        check_vma=False,
    )(shards, weights, thresholds, lengths)


def sharded_scan_hits_2d(scanner, codes: np.ndarray, mesh: Mesh):
    """The fused scan pipeline over the 2-D mesh: per-shard packed hit
    rows all_gather over 'chip' first, then 'host', so every device
    holds the global row set.  Host decode rebases each shard's row by
    its flat (host, chip) position — identical global stream to the 1-D
    :func:`.shard.sharded_scan_hits`."""
    from ..ops.microhit import scan_hits

    t = scanner.tables
    W, thr, classes = scanner._filter_weights()
    halo = t.Lmax - 1 + scanner.k
    shards, shard_len = shard_codes_2d(
        np.asarray(codes), mesh, halo, t.eos_code)
    shards = jnp.asarray(shards, jnp.uint8)
    H, C = mesh.devices.shape

    while True:
        cap_mb, hit_cap = scanner._cap_mb, scanner._hit_cap

        def per_shard(codes_block, W, thr, wconv, thresholds, lengths):
            row = scan_hits(
                codes_block[0, 0], W, thr, wconv, thresholds, lengths,
                classes=classes, alpha=t.alpha, Lmax=t.Lmax,
                eos_code=t.eos_code, MB=scanner._MB, cap_mb=cap_mb,
                hit_cap=hit_cap,
            )
            row = jax.lax.all_gather(row, "chip")   # [C, row]
            row = jax.lax.all_gather(row, "host")   # [H, C, row]
            return row[None, None]

        rows = jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P("host", "chip", None), P(), P(), P(), P(), P()),
            out_specs=P("host", "chip", None, None, None),
            check_vma=False,
        )(shards, W, thr, scanner.weights, scanner.thresholds,
          scanner.lengths_dev)
        rows = np.asarray(jax.device_get(rows[0, 0]))  # [H, C, rowlen]
        rows = rows.reshape(H * C, -1)
        if (rows[:, 0] <= cap_mb).all() and (rows[:, 1] <= hit_cap).all():
            break
        scanner._cap_mb = max(
            cap_mb, 1 << (max(int(rows[:, 0].max()), 1) - 1).bit_length())
        scanner._hit_cap = max(
            hit_cap, 1 << (max(int(rows[:, 1].max()), 1) - 1).bit_length())

    def gen():
        for i in range(rows.shape[0]):
            base = i * shard_len
            for end, pid, mism in scanner._decode_packed(
                    rows[i], None, shard_len, (cap_mb, hit_cap)):
                yield end + base, pid, mism

    return gen()
