"""Deferred jax binding for modules on the host-served one-shot path.

Host-native one-shot tools (shift-and, Sellers rows, mer census) must not
pay the jax import, and the site-less ``sat`` launcher boots without it.
Modules whose *import* must stay jax-free but whose device paths use jax
bind ``jax``/``jnp`` through :class:`LazyModule` and decorate
module-level jitted functions with :func:`lazy_jit` (a plain
``@jax.jit`` at module scope would trigger the import at def time).
"""

from __future__ import annotations

import functools


class LazyModule:
    """Import ``name`` on first attribute access and swap the real module
    into the owning module's globals under ``binding``."""

    def __init__(self, name: str, binding: str, owner_globals: dict):
        self._name = name
        self._binding = binding
        self._owner = owner_globals

    def __getattr__(self, attr):
        import importlib

        mod = importlib.import_module(self._name)
        self._owner[self._binding] = mod
        return getattr(mod, attr)


def lazy_jit(fn=None, **jit_kwargs):
    """``@jax.jit`` whose wrap (and therefore the jax import) happens at
    first CALL, not at def time.  Supports the decorated function's
    ordinary call protocol only — module-level jitted helpers here are
    called, never introspected."""

    def deco(f):
        box = []

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not box:
                import jax

                box.append(jax.jit(f, **jit_kwargs))
            return box[0](*args, **kwargs)

        return wrapper

    return deco(fn) if fn is not None else deco


def on_gpu() -> bool:
    """True when JAX's default backend is the GPU.  The device routes
    (the fused microhit pipeline, the XLA Sellers scan) are chosen on
    this; the CPU takes the host machines and the XLA block scans."""
    import jax

    return jax.default_backend() == "gpu"
