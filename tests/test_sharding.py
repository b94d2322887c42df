"""Multi-device equivalence on a virtual 8-device CPU mesh.

The reference has no distributed mode at all; the invariant here is the
one that matters for the multi-card build (SURVEY.md section 4): a k-device
sharded run produces the same scores as the single-device run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussdca_tpu.api import scores_pipeline
from gaussdca_tpu.parallel import mesh as meshlib
from gaussdca_tpu.parallel.sharded import run_sharded

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices")


def _toy(M=64, N=24, q=8, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(1, q + 1, size=(M, N), dtype=np.int8))


@pytest.mark.parametrize("score", ["frob", "DI"])
@pytest.mark.parametrize("theta", ["auto", 0.2])
def test_sharded_equals_single_device(score, theta):
    q = 8
    Z = _toy(q=q)
    dtype = jnp.float64

    S0, th0, meff0 = scores_pipeline(
        Z, jnp.asarray(0.5, dtype), jnp.asarray(0.0 if theta == "auto"
                                                else theta, dtype),
        q=q, score=score, theta_is_auto=(theta == "auto"),
        dtype=dtype, use_pallas=False)

    m = meshlib.make_mesh(8, shape=(4, 2))
    S1, th1, meff1 = run_sharded(m, Z, 0.5, theta, q=q, score=score,
                                 dtype=dtype)

    assert float(th1) == pytest.approx(float(th0), rel=1e-12)
    assert float(meff1) == pytest.approx(float(meff0), rel=1e-12)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S0),
                               rtol=1e-9, atol=1e-12)


def test_mesh_shapes():
    m = meshlib.make_mesh(8)
    assert m.devices.size == 8
    assert m.axis_names == ("data", "model")
    with pytest.raises(ValueError):
        meshlib.make_mesh(8, shape=(3, 2))


@pytest.mark.parametrize("score,buckets", [("frob", (0, 0)),
                                           ("DI", (0, 0)),
                                           ("frob", (32, 32))])
def test_api_mesh_dispatch(score, buckets):
    """The public entry point dispatches to the sharded pipeline
    (VERDICT r1 item 1): gdca_from_msa(..., mesh=...) matches the
    single-chip run, with and without shape buckets."""
    from gaussdca_tpu.api import gdca_from_msa
    from gaussdca_tpu.core.config import GDCAConfig
    from gaussdca_tpu.io.fasta import MSA

    q = 8
    Z = np.asarray(_toy(M=48, N=24, q=q), dtype=np.uint8)
    msa = MSA(tokens=Z, headers=[f"s{i}" for i in range(Z.shape[0])], q=q)
    mb, nb = buckets
    cfg = GDCAConfig(pseudocount=0.5, theta="auto", score=score,
                     min_separation=2, m_bucket=mb, n_bucket=nb)
    r0 = gdca_from_msa(msa, cfg)
    m = meshlib.make_mesh(8, shape=(4, 2))
    r1 = gdca_from_msa(msa, cfg, mesh=m)
    assert r1.theta == pytest.approx(r0.theta, rel=1e-12)
    assert r1.meff == pytest.approx(r0.meff, rel=1e-12)
    got0 = {(i, j): x for i, j, x in r0.ranking}
    got1 = {(i, j): x for i, j, x in r1.ranking}
    assert set(got0) == set(got1)
    for k, v in got0.items():
        assert got1[k] == pytest.approx(v, rel=1e-9, abs=1e-12)


def test_api_mesh_spec_forms():
    """mesh='auto' and mesh=(dp, tp) resolve; bad specs raise."""
    from gaussdca_tpu.api import resolve_mesh

    m = resolve_mesh("auto")
    assert m.devices.size == jax.device_count()
    m2 = resolve_mesh((2, 4))
    assert dict(m2.shape) == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        resolve_mesh("bogus")


def test_cli_mesh_golden(tmp_path, golden_dir):
    """CLI --mesh 4,2 on the virtual 8-device mesh reproduces the golden
    frob ranking (VERDICT r1 item 1 'done' criterion)."""
    import os
    from gaussdca_tpu.cli import main

    rc = main([os.path.join(golden_dir, "small.fasta.gz"),
               "-o", str(tmp_path), "--mesh", "4,2", "--quiet",
               "--m-bucket", "0", "--n-bucket", "0",
               "--compile-cache", "none"])
    assert rc == 0
    out = tmp_path / "small.rank.txt"
    want = {}
    for line in open(os.path.join(golden_dir, "small.FNRout.txt")):
        t = line.split()
        want[(int(t[0]), int(t[1]))] = float(t[2])
    got = {}
    for line in out.read_text().splitlines():
        t = line.split()
        got[(int(t[0]), int(t[1]))] = float(t[2])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6)


def test_sharded_ranking_matches(golden_dir):
    """End-to-end: sharded run reproduces the single-device golden ranking
    (small alignment, frob defaults) on the virtual mesh."""
    import os
    from gaussdca_tpu.io import fasta
    from gaussdca_tpu.score.rank import compute_ranking

    msa = fasta.read_fasta_alignment(
        os.path.join(golden_dir, "small.fasta.gz"), 0.9)
    m = meshlib.make_mesh(8, shape=(4, 2))
    S, th, meff = run_sharded(m, jnp.asarray(msa.tokens), 0.8, "auto",
                              q=msa.q, score="frob", dtype=jnp.float64)
    R = compute_ranking(np.asarray(S), 5)
    want = {}
    for line in open(os.path.join(golden_dir, "small.FNRout.txt")):
        t = line.split()
        want[(int(t[0]), int(t[1]))] = float(t[2])
    got = {(i, j): x for i, j, x in R}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6)


def test_sharded_di_batch_minor_branch(monkeypatch):
    """The mesh-sharded batch-minor DI branch (minor-axis lane sharding)
    must match the single-device f32 run — exercised by lowering the
    P gate so the toy size takes the bm path."""
    from gaussdca_tpu.score import di as dimod
    from gaussdca_tpu.parallel import sharded as shmod

    monkeypatch.setattr(dimod, "_BM_MIN_PAIRS", 1)

    q = 8
    Z = _toy(M=48, N=24, q=q)
    dtype = jnp.float32
    S0, th0, meff0 = scores_pipeline(
        Z, jnp.asarray(0.5, dtype), jnp.asarray(0.2, dtype),
        q=q, score="DI", theta_is_auto=False, dtype=dtype,
        use_pallas=False)

    m = meshlib.make_mesh(8, shape=(4, 2))
    S1, th1, meff1 = shmod.run_sharded(
        m, Z, 0.5, 0.2, q=q, score="DI", dtype=dtype, use_pallas=False)
    # direct check: the mesh-sharded bm DI vs the mesh-sharded fallback
    # DI on the same (mJ, C), recomputed exactly as the pipeline does
    with jax.default_matmul_precision("highest"):
        from gaussdca_tpu.api import _stats_body
        C, _, _ = _stats_body(Z, jnp.asarray(0.5, dtype),
                              jnp.asarray(0.2, dtype), q=q,
                              theta_is_auto=False, dtype=dtype,
                              use_pallas=False, m_true=None)
        from gaussdca_tpu.solve.cholesky import spd_inverse
        mJ = spd_inverse(C)
        S_bm = shmod._di_sharded(m, mJ, C, q, use_pallas=True)
        S_ref = shmod._di_sharded(m, mJ, C, q, use_pallas=False)
    np.testing.assert_allclose(np.asarray(S_bm), np.asarray(S_ref),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S0),
                               rtol=1e-4, atol=1e-6)
