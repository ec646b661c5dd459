"""compact_mask contract tests: identical to ``jnp.nonzero(mask, size=cap,
fill_value=mask.size)`` plus an exact total count, across both the single
top_k and the two-level chunked implementations (the scan pipelines'
"variable-rate hit emission" primitive — correctness must not depend on
capacity, SURVEY §7 hard-parts)."""

import jax.numpy as jnp
import numpy as np
import pytest

from sequence_alignment_tools.ops.compact import compact_mask


def _check(mask: np.ndarray, cap: int, chunk):
    n = mask.size
    count, idx = compact_mask(jnp.asarray(mask), cap, chunk)
    ref = np.flatnonzero(mask)
    assert int(count) == ref.size
    exp = np.full(cap, n, np.int64)
    m = min(cap, ref.size)
    exp[:m] = ref[:m]
    assert np.array_equal(np.asarray(idx), exp)


@pytest.mark.parametrize("n", [1, 200, 70_000, 500_000])
@pytest.mark.parametrize("p", [0.0, 1e-4, 0.05, 1.0])
def test_random_masks(n, p):
    rng = np.random.default_rng(n + int(p * 1e6))
    mask = rng.random(n) < p
    for cap in (1, 16, 1024):
        for chunk in (None, 64, 1000):
            _check(mask, cap, chunk)


def test_adversarial_chunk_layout():
    """Hits crammed into one chunk, on chunk borders, and overflowing."""
    n = 100_000
    mask = np.zeros(n, bool)
    mask[-70:] = True
    mask[[0, 127, 128]] = True
    for cap in (2, 64, 4096):
        _check(mask, cap, 128)


def test_cap_exceeds_size():
    mask = np.array([True, False, True])
    _check(mask, 8, None)
