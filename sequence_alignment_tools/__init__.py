"""Multi-pattern sequence matching framework on JAX.

A re-design of the PrimerMatch/PeptideScan capability set
(EdwardsLabProjects/sequence-alignment-tools) around a data-parallel
accelerator:

- The sequence database is a flat, EOS-delimited ``uint8`` code array in
  device memory (the reference's ``.sqn`` normalized flat coordinate space,
  ``fasta_io.t:139-263``), position-sharded across a device mesh with static
  overlap halos.
- Exact and k-mismatch multi-pattern scanning runs as a fused one-hot
  correlation filter (the reference scans char-at-a-time through an
  Aho-Corasick keyword tree / shift-and bitvectors, ``keyword_tree.t:427-486``,
  ``shift_and.cc:218-254``).
- k-edit (indel) scanning runs as a row-vectorized Sellers semi-global DP
  (same candidate set as the reference's Wu-Manber bitvectors,
  ``shift_and_inexact.cc:249-350``).
- Candidate clusters are verified by a banded anchored edit-distance DP that
  reproduces the reference's tie-breaking and constraint semantics bit-for-bit
  (``pattern_alignment.cc:117-705``).

Import alias: ``import sequence_alignment_tools as sat``.
"""

__version__ = "0.1.0"

import os as _os

# the compile cache's home when JAX_COMPILATION_CACHE_DIR is unset: one
# fixed directory inside the checkout (the path is part of the cache key,
# so a moving directory would never hit)
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _setup_compilation_cache() -> None:
    """Persistent XLA compilation cache so repeated CLI invocations don't
    pay recompilation (the scan pipelines are shape-stable across runs).
    ``JAX_COMPILATION_CACHE_DIR``, when set, is jax's own setting and is
    left alone."""
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def _honor_platform_env() -> None:
    """Re-apply ``JAX_PLATFORMS`` in case jax was imported before the
    variable was set (backends are still uninitialized at package-import
    time)."""
    plat = _os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)


class _LazyJaxBoot:
    """Deferred jax configuration for the site-less ``sat`` launcher
    (``python -S``).

    Host-native tools (shift-and, Sellers rows, mer census — the whole
    one-shot regime) never import jax.  When a device route *does*, this
    hook fires on the first top-level ``import jax``: it completes the
    real import, applies the package's cache/platform config, and hands
    the import machinery a no-op loader for the already-initialized
    module (re-exec would double-run jax's init).
    """

    def find_spec(self, name, path=None, target=None):
        if name != "jax" or path is not None:
            return None
        import importlib
        import importlib.util

        try:
            _sys.meta_path.remove(self)
        except ValueError:  # pragma: no cover - already fired
            return None
        mod = importlib.import_module("jax")
        _setup_compilation_cache()
        _honor_platform_env()

        class _Reuse(importlib.abc.Loader):
            def create_module(self, spec):
                return mod

            def exec_module(self, module):
                pass

        return importlib.util.spec_from_loader("jax", _Reuse())


import sys as _sys

if "jax" in _sys.modules:
    _setup_compilation_cache()
    _honor_platform_env()
else:
    # defer everything jax until a route actually needs the device;
    # host-native tools stay jax-free
    import importlib.abc  # noqa: F401  (used inside the hook)

    _sys.meta_path.insert(0, _LazyJaxBoot())

from . import utils  # noqa: F401
