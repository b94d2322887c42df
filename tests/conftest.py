"""Test configuration.

Golden-parity tests run in f64 on the CPU backend (the reference's golden
files demand ~1e-8 relative agreement, SURVEY.md section 4); multi-device
sharding tests run on a virtual 8-device CPU mesh. Both require env setup
before jax initializes, hence this conftest sets it at import time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# The suite runs on the CPU backend. The config update is honored only
# while no backend is initialized: when chip_smoke.py runs the card-only
# (``gpu``-marked) tests in its own process, the card's backend already
# exists and stays the default.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest

# Golden data is vendored (tests/data/, see PROVENANCE.md) so the parity
# tests always RUN — no silent skip in CI. GAUSSDCA_GOLDEN_DIR overrides
# (e.g. to validate against a live reference checkout instead).
_VENDORED = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_DIR = os.environ.get("GAUSSDCA_GOLDEN_DIR", _VENDORED)


@pytest.fixture(scope="session")
def golden_dir():
    if not os.path.isfile(os.path.join(GOLDEN_DIR, "small.fasta.gz")):
        # a missing dir is a broken checkout/override, not a skippable
        # environment condition — fail loudly
        raise RuntimeError(f"golden data dir not available: {GOLDEN_DIR}")
    return GOLDEN_DIR
