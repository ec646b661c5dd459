"""Mesh sharding, multihost bring-up, and out-of-process host tails.

Lazy re-exports (PEP 562): ``shard`` imports jax at module level, and
host-routed one-shot runs must stay jax-free.  ``from .parallel.shard
import ...`` still works and pays the import only when a device route
actually needs it.
"""

_SHARD_EXPORTS = ("make_mesh", "sharded_scan_counts", "shard_codes")


def __getattr__(name):
    if name in _SHARD_EXPORTS:
        from . import shard

        return getattr(shard, name)
    raise AttributeError(name)
