"""jax-free peek at the on-disk device-count cache.

``shard.auto_mesh`` caches the host's device COUNT so known
single-device machines skip backend initialization (see its docstring
for the refresh protocol).  Host-routed one-shot runs need one more step
removed: even *importing* ``parallel.shard`` costs the full jax import.
This module answers the only question the model build needs — "is this
definitely the single-device / no-mesh posture?" — with stdlib only;
anything else falls through to the real ``auto_mesh`` (paying the import
at most once per staleness window).
"""

from __future__ import annotations

import os
import tempfile
import time

STALE_S = 600  # auto_mesh's staleness window — keep in sync


def devcount_cache_path() -> str:
    key = "%s_%s" % (os.uname().nodename,
                     os.environ.get("JAX_PLATFORMS", "auto"))
    key = "".join(c if c.isalnum() else "_" for c in key)
    return os.path.join(tempfile.gettempdir(), "sat_devcount_" + key)


def peek_no_mesh() -> bool:
    """True when auto_mesh would certainly return ``None`` without
    touching jax: SAT_MESH explicitly disabled, or auto mode with a
    FRESH cached device count of 1 (a stale cache must fall through so
    auto_mesh can arm its refresh protocol)."""
    spec = os.environ.get("SAT_MESH", "auto").strip().lower()
    if spec in ("0", "1", "off", "none"):
        return True
    if spec not in ("", "auto"):
        return False
    path = devcount_cache_path()
    try:
        with open(path) as f:
            cached = int(f.read().strip())
        fresh = (time.time() - os.path.getmtime(path)) <= STALE_S
    except (OSError, ValueError):
        return False
    return cached == 1 and fresh
