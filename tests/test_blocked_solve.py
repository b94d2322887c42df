"""Mesh-blocked Cholesky / distributed SPD inverse vs the dense solver.

The distributed solve must agree with the replicated one to factorization
round-off — the same optimized-vs-fallback cross-check discipline the
reference applies to its kernels (/root/reference/test/runtests.jl:78-86).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussdca_tpu.parallel import mesh as meshlib
from gaussdca_tpu.solve.blocked import (blocked_cholesky, spd_inverse_blocked,
                                        tri_inverse_apply)
from gaussdca_tpu.solve.cholesky import spd_inverse


def _spd(n, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    C = A @ A.T / n + 0.5 * np.eye(n)
    return jnp.asarray(C, dtype)


@pytest.mark.parametrize("n,block", [(64, 64), (96, 32), (100, 32),
                                     (200, 64), (33, 16)])
def test_blocked_cholesky_matches_dense(n, block):
    C = _spd(n, seed=n)
    L0 = np.asarray(jnp.linalg.cholesky(C))
    L1 = np.asarray(blocked_cholesky(C, block=block))
    np.testing.assert_allclose(L1, L0, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("n,block", [(100, 32), (256, 64)])
def test_spd_inverse_blocked_no_mesh(n, block):
    C = _spd(n, seed=3 * n)
    got = np.asarray(spd_inverse_blocked(C, block=block))
    want = np.asarray(spd_inverse(C))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
@pytest.mark.parametrize("n,block", [(96, 32), (100, 16), (264, 64)])
def test_spd_inverse_blocked_on_mesh(n, block):
    C = _spd(n, seed=7 * n)
    m = meshlib.make_mesh(8, shape=(4, 2))
    got = np.asarray(spd_inverse_blocked(C, block=block, mesh=m))
    want = np.asarray(spd_inverse(C))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_tri_inverse_apply_pads_columns():
    # n not divisible by the 8-way column sharding
    n = 67
    C = _spd(n, seed=5)
    L = jnp.linalg.cholesky(C)
    m = meshlib.make_mesh(8, shape=(4, 2))
    got = np.asarray(tri_inverse_apply(L, mesh=m))
    want = np.asarray(spd_inverse(C))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
@pytest.mark.parametrize("score", ["frob", "DI"])
def test_sharded_pipeline_with_blocked_solve(score):
    """Force the blocked solve in the full sharded pipeline (threshold 1)
    and check it still matches the single-device scores."""
    from gaussdca_tpu.api import scores_pipeline
    from gaussdca_tpu.parallel.sharded import run_sharded

    q = 8
    rng = np.random.default_rng(17)
    Z = jnp.asarray(rng.integers(1, q + 1, size=(64, 24), dtype=np.int8))
    dtype = jnp.float64

    S0, th0, meff0 = scores_pipeline(
        Z, jnp.asarray(0.5, dtype), jnp.asarray(0.2, dtype),
        q=q, score=score, theta_is_auto=False, dtype=dtype,
        use_pallas=False)

    m = meshlib.make_mesh(8, shape=(4, 2))
    S1, th1, meff1 = run_sharded(m, Z, 0.5, 0.2, q=q, score=score,
                                 dtype=dtype, solve_min_dim=1,
                                 solve_block=64)
    assert float(meff1) == pytest.approx(float(meff0), rel=1e-12)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S0),
                               rtol=1e-8, atol=1e-11)


def test_doubling_plan_geometry():
    from gaussdca_tpu.solve.cholesky import _doubling_plan

    for n in (1060, 2048, 2500, 4000, 8000, 20000):
        npad, base, k = _doubling_plan(n)
        assert npad == base * (1 << k)
        assert npad >= n
        assert base % 128 == 0
        # bounded padding overhead
        assert npad - n <= (1 << k) * 128


def test_tri_inverse_doubling_matches_trsm():
    from jax.scipy.linalg import solve_triangular
    from gaussdca_tpu.solve.cholesky import (_doubling_plan,
                                             tri_inverse_doubling)

    rng = np.random.default_rng(9)
    n = 640  # 5 * 128: forces base=320? -> plan gives base*2^k >= n
    A = rng.standard_normal((n, 256)).astype(np.float64)
    C = A @ A.T / 256 + n * np.eye(n)
    L = np.linalg.cholesky(C)
    npad, base, _ = _doubling_plan(n, base_target=128)
    Lp = np.eye(npad)
    Lp[:n, :n] = L
    got = np.asarray(tri_inverse_doubling(jnp.asarray(Lp), base))[:n, :n]
    want = np.asarray(solve_triangular(jnp.asarray(L), jnp.eye(n),
                                       lower=True))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_spd_inverse_doubling_path_f32():
    """The f32 doubling fast path agrees with the cho_solve path to the
    Newton floor (it engages for 2048 <= Ns <= 24576 in f32)."""
    from gaussdca_tpu.solve.cholesky import (_spd_inverse_doubling,
                                             spd_inverse)

    rng = np.random.default_rng(10)
    n = 2100  # odd size: exercises the identity padding
    A = rng.standard_normal((n, 256)).astype(np.float32)
    C = jnp.asarray(A @ A.T / 256 + 0.05 * n * np.eye(n, dtype=np.float32))
    got = np.asarray(_spd_inverse_doubling(C, 1))
    want = np.asarray(spd_inverse(C.astype(jnp.float64)))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 5e-5, err


def test_syrk_lower_blocked_matches_dense():
    """The blocked triangular syrk (a solve candidate) is the
    same product as Li^T @ Li with the structurally-zero block products
    skipped — identical to dense up to (block) summation order."""
    from gaussdca_tpu.solve.cholesky import syrk_lower_blocked

    rng = np.random.default_rng(11)
    base = 128
    for nb, dtype, tol in ((1, np.float64, 1e-13), (3, np.float64, 1e-13),
                           (4, np.float32, 2e-5)):
        n = base * nb
        L = np.tril(rng.standard_normal((n, n))).astype(dtype)
        idx = np.arange(n)
        L[idx, idx] = np.abs(L[idx, idx]) + 1.0
        got = np.asarray(syrk_lower_blocked(jnp.asarray(L), base))
        want = L.T @ L
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def test_solve_env_knobs(monkeypatch):
    """GDCA_SOLVE_SYRK / GDCA_SOLVE_RES_PREC are trace-time A/B knobs:
    the blocked-syrk doubling path must agree with the dense-syrk
    default to the Newton floor, and the residual-precision map must
    default to HIGHEST (a coarser residual floor can break the golden
    rank identity)."""
    from gaussdca_tpu.solve.cholesky import (_residual_precision,
                                             _spd_inverse_doubling,
                                             _syrk_impl)

    monkeypatch.delenv("GDCA_SOLVE_RES_PREC", raising=False)
    assert _residual_precision() == jax.lax.Precision.HIGHEST
    monkeypatch.setenv("GDCA_SOLVE_RES_PREC", "high")
    assert _residual_precision() == jax.lax.Precision.HIGH
    monkeypatch.delenv("GDCA_SOLVE_SYRK", raising=False)
    assert _syrk_impl() == "dense"

    rng = np.random.default_rng(12)
    n = 2100  # odd: exercises the identity padding inside the plan
    A = rng.standard_normal((n, 256)).astype(np.float32)
    C = jnp.asarray(A @ A.T / 256 + 0.05 * n * np.eye(n, dtype=np.float32))
    monkeypatch.setenv("GDCA_SOLVE_RES_PREC", "highest")
    base = np.asarray(_spd_inverse_doubling(C, 1))
    monkeypatch.setenv("GDCA_SOLVE_SYRK", "blocked")
    blk = np.asarray(_spd_inverse_doubling(C, 1))
    scale = np.abs(base).max()
    assert np.abs(blk - base).max() / scale < 5e-6, \
        np.abs(blk - base).max() / scale
    # accuracy vs f64 ground truth holds through the blocked syrk
    from gaussdca_tpu.solve.cholesky import spd_inverse
    want = np.asarray(spd_inverse(C.astype(jnp.float64)))
    assert np.abs(blk - want).max() / np.abs(want).max() < 5e-5


def test_syrk_lower_slab_matches_dense(monkeypatch):
    """The slab syrk (the alternative to the windowed-accumulator
    blocked form) is the same product as Li^T @ Li:
    lower-triangularity makes X[j0:, slab] = Li[j0:, j0:]^T Li[j0:, slab]
    exact, and the block-upper triangle is the mirrored transpose."""
    from gaussdca_tpu.solve.cholesky import (_spd_inverse_doubling,
                                             syrk_lower_slab)

    rng = np.random.default_rng(13)
    for n, dtype, tol in ((128, np.float64, 1e-13),
                          (256, np.float64, 1e-13),
                          (512, np.float32, 2e-5)):
        L = np.tril(rng.standard_normal((n, n))).astype(dtype)
        idx = np.arange(n)
        L[idx, idx] = np.abs(L[idx, idx]) + 1.0
        got = np.asarray(syrk_lower_slab(jnp.asarray(L)))
        want = L.T @ L
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())

    # and through the doubling solve, against the dense-syrk default
    rng = np.random.default_rng(14)
    n = 2100
    A = rng.standard_normal((n, 256)).astype(np.float32)
    C = jnp.asarray(A @ A.T / 256 + 0.05 * n * np.eye(n, dtype=np.float32))
    monkeypatch.delenv("GDCA_SOLVE_SYRK", raising=False)
    base = np.asarray(_spd_inverse_doubling(C, 1))
    monkeypatch.setenv("GDCA_SOLVE_SYRK", "slab")
    slab = np.asarray(_spd_inverse_doubling(C, 1))
    assert np.abs(slab - base).max() / np.abs(base).max() < 5e-6
