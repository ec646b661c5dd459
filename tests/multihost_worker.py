"""Worker process for the 2-process jax.distributed parity test.

Usage: python multihost_worker.py <process_id> <port> <outdir>

Each of the two processes owns 4 virtual CPU devices; together they form
the ('host', 'chip') = (2, 4) mesh of parallel.multihost — process_id IS
the host row.  The worker runs the 2-D sharded count scan on a
deterministic problem and writes its replicated count vector (plus the
(process_index, process_count) bring-up result) to <outdir>/p<id>.npz.
"""

import os
import sys


def main():
    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ["SAT_COORDINATOR"] = f"localhost:{port}"
    os.environ["SAT_NUM_PROCESSES"] = "2"
    os.environ["SAT_PROCESS_ID"] = str(pid)
    import jax

    jax.config.update("jax_platforms", "cpu")
    # NOT --xla_force_host_platform_device_count: the forced-host-device
    # path builds a single-process client even when the coordination
    # service is connected.  jax_num_cpu_devices + gloo collectives is
    # the real multi-process CPU bring-up.
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_num_cpu_devices", 4)

    import numpy as np

    from sequence_alignment_tools.parallel.multihost import (
        init_distributed,
        make_host_chip_mesh,
        shard_codes_2d,
        sharded_scan_counts_2d,
    )

    i, nproc = init_distributed()
    assert (i, nproc) == (pid, 2), (i, nproc)
    assert len(jax.devices()) == 8 and len(jax.local_devices()) == 4

    mesh = make_host_chip_mesh()  # (2, 4) across the two processes
    assert mesh.devices.shape == (2, 4)

    import jax.numpy as jnp

    P, Lmax, alpha = 6, 10, 5
    rng = np.random.default_rng(0)
    n = 8 * 512
    codes = rng.integers(0, 4, size=n).astype(np.int32)
    weights = np.zeros((Lmax, alpha, P), np.float32)
    pats = rng.integers(0, 4, size=(P, Lmax))
    for p in range(P):
        for j in range(Lmax):
            weights[j, pats[p, j], p] = 1.0

    shards, _ = shard_codes_2d(codes, mesh, Lmax - 1, eos_code=4)
    counts = sharded_scan_counts_2d(
        shards,
        jnp.asarray(weights, dtype=jnp.bfloat16),
        jnp.asarray(np.full(P, float(Lmax), np.float32)),
        jnp.asarray(np.full(P, Lmax, np.int32)),
        alpha,
        mesh,
    )
    # replicated psum result: every addressable shard must agree
    local = [np.asarray(s.data).reshape(-1, P)
             for s in counts.addressable_shards]
    for sh in local[1:]:
        np.testing.assert_array_equal(sh, local[0])
    np.savez(os.path.join(outdir, f"p{pid}.npz"),
             counts=local[0][0], pid=np.int64(i), nproc=np.int64(nproc))
    print(f"worker {pid} ok", flush=True)


if __name__ == "__main__":
    main()
