"""Tests that need an NVIDIA card (marker ``gpu``).

They skip on any other platform; ``chip_smoke.py`` runs them on the card
(``pytest -m gpu``). Whether a card is present is decided inside the
``gpu`` fixture, never at import time.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA card (JAX platform: "
                    f"{device.platform})")
    return device


def _tokens(seed, M, N, q=21, lo=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(lo, q + 1, size=(M, N), dtype=np.int8))


def test_dispatch_resolves_the_gpu_table(gpu):
    from gaussdca_tpu.ops import dispatch
    from gaussdca_tpu.ops.row_stats_triton import row_stats_triton

    assert dispatch.formulation() == dispatch.formulation("gpu")
    assert dispatch.kernels()["row_stats_fn"] is row_stats_triton


def test_row_stats_gemm_is_a_library_gemm(gpu):
    """The s8 x s8 -> s32 dot of the GEMM formulation compiles to a
    cuBLAS GEMM, not a loop fusion."""
    import jax
    import jax.numpy as jnp
    from gaussdca_tpu.ops import distance

    Z = _tokens(0, 4096, 384)
    hlo = jax.jit(lambda z: distance.row_stats_xla(
        z, z, jnp.float32(76.0), 21)).lower(Z).compile().as_text()
    assert "__cublas$gemm" in hlo or "__cublas$lt$matmul" in hlo


@pytest.mark.parametrize("M,N", [(4096, 200), (2000, 384), (1000, 1000)])
def test_kernel_exact_on_card(gpu, M, N):
    """The compiled Hopper kernel against the GEMM formulation: integer
    counts, so exactly equal (padding rows and tokens included)."""
    import jax.numpy as jnp
    from gaussdca_tpu.ops import distance
    from gaussdca_tpu.ops.row_stats_triton import row_stats_triton

    Z = _tokens(M + N, M, N)
    th = jnp.float32(int(0.3 * N))
    got = row_stats_triton(Z, th, 21)
    want = distance.row_stats_xla(Z, Z, th, 21)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_f32_matmul_precisions_on_card(gpu):
    """What the solve's precision choices rest on: DEFAULT and HIGH f32
    products run in TF32 on the card, HIGHEST in full f32."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    A = rng.standard_normal((1024, 1024)).astype(np.float32)
    B = rng.standard_normal((1024, 1024)).astype(np.float32)
    ref = A.astype(np.float64) @ B.astype(np.float64)
    err = {}
    for p in ("default", "high", "highest"):
        got = jax.jit(lambda a, b, p=p: jnp.matmul(a, b, precision=p))(A, B)
        err[p] = float(np.abs(np.asarray(got, np.float64) - ref).max()
                       / np.abs(ref).max())
    assert err["highest"] < 1e-5
    assert err["default"] > 1e-5 and err["high"] > 1e-5


def test_small_golden_f64_on_card(gpu, golden_dir):
    """The card has f64 units: the f64 pipeline reproduces the golden
    ranking to the golden files' printed precision."""
    import jax

    from gaussdca_tpu import gdca
    from gaussdca_tpu.score.rank import format_rank

    assert jax.config.jax_enable_x64  # conftest enables it
    r = gdca(os.path.join(golden_dir, "small.fasta.gz"), dtype="float64")
    got = {}
    for line in format_rank(r.ranking).splitlines():
        i, j, s = line.split()
        got[(int(i), int(j))] = float(s)
    want = {}
    with open(os.path.join(golden_dir, "small.FNRout.txt")) as fh:
        for line in fh:
            i, j, s = line.split()
            want[(int(i), int(j))] = float(s)
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=1e-6,
                               atol=1e-12)
