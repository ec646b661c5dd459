import os
import random
import subprocess

# Tests run on a virtual 8-device CPU mesh.  SAT_TEST_PLATFORM=gpu leaves
# the platform alone so the gpu-marked tests reach the card (chip_smoke.py
# runs them that way); the ``gpu`` fixture skips them everywhere else.
if os.environ.get("SAT_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "--xla_force_host_platform_device_count" not in os.environ.get(
            "XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    # jax may already be imported (a plugin, a sitecustomize), in which
    # case the env vars above are too late for jax's config — override
    # directly (backends are still uninitialized at conftest import time)
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

REF = "/tmp/ref"


def have_oracle() -> bool:
    return os.access(os.path.join(REF, "primer_match"), os.X_OK)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is the GPU (decided here, at
    run time, so every worker collects the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `SAT_TEST_PLATFORM=gpu python -m "
                    "pytest -m gpu tests/test_gpu.py` on the card")


@pytest.fixture(scope="session")
def oracle():
    """Path to the reference binaries, building them on first use."""
    if not have_oracle():
        script = os.path.join(os.path.dirname(__file__), "oracle", "build_reference.sh")
        try:
            subprocess.run(["sh", script], check=True, capture_output=True)
        except subprocess.CalledProcessError:
            pytest.skip("reference oracle not buildable")
    if not have_oracle():
        pytest.skip("reference oracle unavailable")
    return REF


def make_synthetic_fasta(path, n_entries=2, total=50000, planted=(), seed=7,
                         line_width=60, alphabet="ACGT"):
    """Random DNA FASTA with optional planted patterns at known offsets."""
    rng = random.Random(seed)
    seq = [rng.choice(alphabet) for _ in range(total)]
    for pos, pat in planted:
        seq[pos : pos + len(pat)] = list(pat)
    seq = "".join(seq)
    bounds = sorted(rng.sample(range(1000, total - 1000), n_entries - 1)) + [total]
    with open(path, "w") as f:
        start = 0
        for i, end in enumerate(bounds):
            f.write(f">ent{i+1} synthetic entry {i+1}\n")
            for j in range(start, end, line_width):
                f.write(seq[j : min(j + line_width, end)] + "\n")
            start = end
    return seq


PAT = os.path.join(os.path.dirname(__file__), "data", "pat.txt")


@pytest.fixture
def syn_fasta(tmp_path):
    pats = [l.strip() for l in open(PAT) if l.strip()]
    planted = [(1000 + 3000 * i, p) for i, p in enumerate(pats)]
    path = str(tmp_path / "syn.fasta")
    make_synthetic_fasta(path, planted=planted)
    return path
