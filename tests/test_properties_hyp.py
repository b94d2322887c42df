"""Hypothesis-driven invariants (derandomized for CI stability).

Separate module so environments without hypothesis (it is an optional
dev dependency) skip these without losing the deterministic property
tests in test_properties.py.
"""

import pytest

pytest.importorskip("hypothesis")

import jax.numpy as jnp
import numpy as np

from gaussdca_tpu.ops import distance
from gaussdca_tpu.stats import reweight

# -- hypothesis-driven invariants (derandomized for CI stability) --------

from hypothesis import given, settings, strategies as st

_h = settings(deadline=None, max_examples=15, derandomize=True)


@_h
@given(st.integers(2, 12), st.integers(5, 40), st.integers(6, 30),
       st.one_of(st.just("auto"),
                 st.floats(0, 1, allow_nan=False).map(lambda x: round(x, 3))),
       st.integers(0, 2 ** 31 - 1))
def test_hyp_weight_invariants(q, M, N, theta, seed):
    import numpy as np
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    Z = jnp.asarray(rng.integers(1, q + 1, size=(M, N), dtype=np.int8))
    W, Meff, th = reweight.compute_weights(Z, theta)
    W = np.asarray(W)
    assert ((W > 0) & (W <= 1)).all()
    assert 0 < float(Meff) <= M + 1e-9
    assert 0.0 <= float(th) <= 1.0


@_h
@given(st.integers(2, 10), st.integers(3, 30), st.integers(4, 16),
       st.floats(0.01, 0.99), st.integers(0, 2 ** 31 - 1))
def test_hyp_covariance_spd_and_scores_finite(q, M, N, pc, seed):
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.api import scores_pipeline
    rng = np.random.default_rng(seed)
    Z = jnp.asarray(rng.integers(1, q + 1, size=(M, N), dtype=np.int8))
    S, th, meff = scores_pipeline(
        Z, jnp.asarray(pc, jnp.float64), jnp.asarray(0.2, jnp.float64),
        q=q, score="frob", theta_is_auto=False, dtype=jnp.float64,
        use_pallas=False)
    S = np.asarray(S)
    assert np.isfinite(S).all()
    np.testing.assert_allclose(S, S.T, atol=1e-10)


@_h
@given(st.integers(5, 60), st.integers(1, 8), st.integers(0, 2 ** 31 - 1))
def test_hyp_ranking_contract(N, m, seed):
    import numpy as np
    from gaussdca_tpu.score.rank import compute_ranking
    if m >= N:
        return
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((N, N))
    R = compute_ranking(S, m)
    assert len(R) == (N - m) * (N - m + 1) // 2
    assert all(1 <= i < j <= N and j - i >= m for i, j, _ in R)
    scores = [x for _, _, x in R]
    assert scores == sorted(scores, reverse=True)


@_h
@given(st.integers(3, 8), st.integers(4, 25), st.integers(4, 12),
       st.floats(0.05, 0.95), st.integers(0, 2 ** 31 - 1))
def test_hyp_di_finite_symmetric_nonneg_diag0(q, M, N, pc, seed):
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.api import scores_pipeline
    rng = np.random.default_rng(seed)
    Z = jnp.asarray(rng.integers(1, q + 1, size=(M, N), dtype=np.int8))
    S, th, meff = scores_pipeline(
        Z, jnp.asarray(pc, jnp.float64), jnp.asarray(0.2, jnp.float64),
        q=q, score="DI", theta_is_auto=False, dtype=jnp.float64,
        use_pallas=False)
    # pre-APC DI is a mutual information (>= 0); APC can shift it, so
    # check the uncorrected invariants via the internal pieces instead:
    # here assert finiteness + symmetry of the final matrix
    S = np.asarray(S)
    assert np.isfinite(S).all()
    np.testing.assert_allclose(S, S.T, atol=1e-9)


@_h
@given(st.integers(4, 10), st.integers(6, 40), st.integers(6, 14),
       st.sampled_from(["frob", "DI"]),
       st.integers(4, 32), st.integers(4, 16),
       st.integers(0, 2 ** 31 - 1))
def test_hyp_bucketing_equivalence(q, M, N, score, mb, nb, seed):
    """The core batch-mode invariant over the whole config space:
    (M, N)-bucketed runs equal exact-shape runs."""
    import numpy as np
    from gaussdca_tpu import api
    from gaussdca_tpu.core.config import GDCAConfig
    from gaussdca_tpu.io.fasta import MSA
    rng = np.random.default_rng(seed)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.int8)
    Z[0, 0] = q  # pin q
    msa = MSA(tokens=Z, headers=[f"s{i}" for i in range(M)], q=q)
    kw = dict(score=score, pseudocount=0.4, min_separation=1)
    base = api.gdca_from_msa(msa, GDCAConfig(**kw))
    padded = api.gdca_from_msa(
        msa, GDCAConfig(**kw, m_bucket=mb, n_bucket=nb))
    assert base.meff == padded.meff
    assert base.theta == pytest.approx(padded.theta, rel=1e-12)
    want = {(i, j): s for i, j, s in base.ranking}
    got = {(i, j): s for i, j, s in padded.ranking}
    assert set(got) == set(want)
    for k, s0 in want.items():
        assert got[k] == pytest.approx(s0, rel=1e-6, abs=1e-9)


@given(st.integers(30, 140), st.integers(5, 25), st.integers(2, 8),
       st.sampled_from([0, 8, 16, 40]), st.integers(0, 40),
       st.integers(0, 2 ** 31 - 1))
@_h
def test_row_stats_exact(M, N, q, block_rows, ma, seed):
    """The GEMM row stats equal the dense match-matrix reductions for
    arbitrary (M, N, q, row block) and for a rectangular row slice —
    including padding tokens, which match nothing."""
    rng = np.random.default_rng(seed)
    Z = jnp.asarray(rng.integers(0, q + 1, size=(M, N), dtype=np.int8))
    D = np.asarray(reweight.match_counts(Z))
    thresh = float(max(1, N // 3))
    rowsum, below = distance.row_stats_xla(
        Z, Z, jnp.float32(thresh), q, block_rows=block_rows)
    np.testing.assert_array_equal(np.asarray(rowsum), D.sum(1))
    np.testing.assert_array_equal(np.asarray(below),
                                  ((N - D) < thresh).sum(1))
    ma = max(1, min(ma, M))
    ra, ba = distance.row_stats_xla(Z[:ma], Z, jnp.float32(thresh), q)
    np.testing.assert_array_equal(np.asarray(ra), D[:ma].sum(1))
    np.testing.assert_array_equal(np.asarray(ba),
                                  ((N - D[:ma]) < thresh).sum(1))
