"""Row-stats formulations vs the pure-jnp references (exactness).

Counts are small integers, so the GEMM formulation must agree bit-for-bit
with the broadcast-compare reference and with the dense match matrix —
the reference cross-validates its packed kernel against its generic one
the same way (test/runtests.jl:78-86).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussdca_tpu.ops import dispatch, distance
from gaussdca_tpu.ops.row_stats_triton import row_stats_triton
from gaussdca_tpu.stats import reweight


def _sq(Z, thresh, q):
    """Square statistics through the GEMM formulation."""
    return distance.row_stats_xla(Z, Z, thresh, q)


def _kernel(Z, thresh, q, block=32, kc=16):
    """The Hopper kernel in interpret mode (small tiles: multi-tile grids
    at test sizes)."""
    return row_stats_triton(Z, thresh, q, block=block, kc=kc,
                            interpret=True)


def _dense_stats(Z, thresh, rows=None):
    """(rowsum, below) from the dense [M, M] reference match matrix."""
    N = Z.shape[1]
    D = np.asarray(reweight.match_counts(jnp.asarray(Z)))
    if rows is not None:
        D = D[:rows]
    return D.sum(1), ((N - D) < thresh).sum(1)


def _check(got, want):
    rs, below = got
    assert rs.dtype == jnp.int32 and below.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(rs), want[0])
    np.testing.assert_array_equal(np.asarray(below), want[1])


def _tokens(seed, M, N, q, lo=1):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(lo, q + 1, size=(M, N), dtype=np.int8))


@pytest.mark.parametrize("M,N,q", [(7, 5, 3), (64, 53, 21), (130, 40, 21),
                                   (257, 129, 21)])
def test_xla_matches_reference(M, N, q):
    Z = _tokens(M * 1000 + N, M, N, q)
    thresh = float(N // 4)
    got = distance.row_stats_xla(Z, Z, jnp.float32(thresh), q)
    _check(got, _dense_stats(Z, thresh))
    ref = distance.row_stats_rect_jnp(Z, Z, jnp.float32(thresh), q)
    _check(got, tuple(np.asarray(x) for x in ref))


@pytest.mark.parametrize("M,N,q", [(16, 24, 5), (100, 53, 21)])
def test_rect_matches_reference(M, N, q):
    Z = _tokens(M, M, N, q)
    thresh = 6.0
    rows = M // 3
    got = distance.row_stats_xla(Z[:rows], Z, jnp.float32(thresh), q)
    _check(got, _dense_stats(Z, thresh, rows=rows))


def test_padding_rows_are_inert():
    # token-0 rows (and columns) match nothing: appending them changes no
    # real row's statistics, and they score 0 themselves
    Z = _tokens(3, 33, 19, 21)
    Zp = jnp.pad(Z, ((0, 15), (0, 5)))
    thresh = 6.0
    rs, below = distance.row_stats_xla(Zp, Zp, jnp.float32(thresh + 5), 21)
    want = _dense_stats(Z, thresh)
    np.testing.assert_array_equal(np.asarray(rs)[:33], want[0])
    np.testing.assert_array_equal(np.asarray(below)[:33], want[1])
    assert not np.asarray(rs)[33:].any()
    assert not np.asarray(below)[33:].any()


@pytest.mark.parametrize("theta", [0.0, 0.2, 0.5, "auto"])
def test_streaming_weights_match_dense(theta):
    Z = _tokens(7, 70, 31, 21)
    W0, Meff0, th0 = reweight.compute_weights(Z, theta)
    W1, Meff1, th1 = reweight.compute_weights_streaming(
        Z, theta, 21, _sq)
    np.testing.assert_allclose(np.asarray(W1), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)


@pytest.mark.parametrize("M,block", [
    (40, 8),      # 5 blocks, no padding
    (300, 128),   # 3 blocks with a padded tail
    (513, 128),   # 5 blocks, padded
    (520, 104),   # exact multiple
    (1000, 0),    # the planner's own block
])
def test_row_stats_square_matches_dense(M, block):
    Z = _tokens(M, M, 37, 21)
    thresh = 9.0
    got = distance.row_stats_xla(Z, Z, jnp.float32(thresh), 21,
                                 block_rows=block)
    _check(got, _dense_stats(Z, thresh))


@pytest.mark.parametrize("theta", [0.0, 0.3, "auto"])
def test_streaming_weights_blocked(theta):
    # several row blocks: the lax.map stacking must keep row order
    Z = _tokens(11, 310, 29, 21)
    W0, Meff0, th0 = reweight.compute_weights(Z, theta)
    W1, Meff1, th1 = reweight.compute_weights_streaming(
        Z, theta, 21,
        lambda z, t, q: distance.row_stats_xla(z, z, t, q, block_rows=64))
    np.testing.assert_allclose(np.asarray(W1), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)


def test_row_stats_values():
    M, N, q = 40, 17, 6
    Z = _tokens(8, M, N, q)
    thresh = 4.0
    got = _sq(Z, jnp.float32(thresh), q)
    _check(got, _dense_stats(Z, thresh))


@pytest.mark.parametrize("q", [2, 21, 22, 31])
def test_row_stats_q_boundaries(q):
    """q=2 (minimum meaningful alphabet), q=21 (protein), q=22 (first
    beyond it), q=31 (the reference's 5-bit-packing limit,
    src/GaussDCA.jl:26)."""
    M, N = 96, 40
    Z = _tokens(q, M, N, q)
    thresh = 7.0
    _check(distance.row_stats_xla(Z, Z, jnp.float32(thresh), q,
                                  block_rows=32),
           _dense_stats(Z, thresh))
    _check(distance.row_stats_xla(Z[:40], Z, jnp.float32(thresh), q),
           _dense_stats(Z, thresh, rows=40))


def test_row_stats_wide_alignment():
    """q=31 at a wide alignment (K = N*q = 47616): exact through one
    GEMM per block."""
    q, N, M = 31, 1536, 96
    Z = _tokens(31, M, N, q)
    thresh = 300.0
    _check(_sq(Z, jnp.float32(thresh), q),
           _dense_stats(Z, thresh))


@pytest.mark.parametrize("N", [5, 13, 19, 31])
def test_width_padding_is_inert(N):
    """Widths off the GEMM's 32-token alignment are zero-padded inside
    ``row_stats_xla``; the padding must not shift any hamming distance
    (n_valid stays the true width)."""
    Z = _tokens(N, 50, N, 21)
    thresh = float(max(1, N // 2))
    _check(_sq(Z, jnp.float32(thresh), 21),
           _dense_stats(Z, thresh))


def test_plan_block_rows_bounds_the_product():
    """The per-block [block, Mb] int32 product stays under the budget,
    blocks are aligned, and the split has no near-empty tail."""
    align = distance._ROW_ALIGN
    for Ma, Mb in ((7, 7), (1000, 1000), (32768, 32768),
                   (100_000, 100_000), (25_000, 100_000)):
        b = distance.plan_block_rows(Ma, Mb)
        assert b % align == 0 and b >= align
        assert b * Mb * 4 <= distance._BLOCK_PRODUCT_BYTES or b == align
        n_blocks = -(-Ma // b)
        assert n_blocks * b - Ma < b  # padding stays under one block
        assert n_blocks * b - Ma < align * n_blocks


def test_plan_block_rows_single_block_when_small():
    assert distance.plan_block_rows(40, 40) == distance._ROW_ALIGN
    assert distance.plan_block_rows(300, 300) == 3 * distance._ROW_ALIGN


@pytest.mark.parametrize("M", [64, 200, 333])
def test_square_equals_rect_pieces(M):
    """Square stats == the concatenated rectangular stats of row pieces
    against the full matrix (the mesh path's per-device decomposition)."""
    Z = _tokens(M + 5, M, 23, 21)
    th = jnp.float32(6.0)
    rs, below = _kernel(Z, th, 21)
    cut = M // 3
    a = distance.row_stats_xla(Z[:cut], Z, th, 21)
    b = distance.row_stats_xla(Z[cut:], Z, th, 21)
    np.testing.assert_array_equal(np.asarray(rs),
                                  np.concatenate([a[0], b[0]]))
    np.testing.assert_array_equal(np.asarray(below),
                                  np.concatenate([a[1], b[1]]))


@pytest.mark.parametrize("thresh", [0.0, 0.5, 6.0, 6.5, 23.0, 24.0])
def test_threshold_is_strict(thresh):
    """neighbor iff hamming < thresh (strict, like the reference), for
    integral and fractional thresholds alike; thresh 0 counts nobody."""
    Z = _tokens(2, 60, 23, 4)
    _check(_sq(Z, jnp.float32(thresh), 4),
           _dense_stats(Z, thresh))


def test_row_stats_under_highest_precision():
    """The ambient 'highest' context of the pipeline must not change the
    integer GEMM (its precision is pinned to DEFAULT)."""
    Z = _tokens(4, 90, 33, 21)
    th = jnp.float32(8.0)
    with jax.default_matmul_precision("highest"):
        got = _sq(Z, th, 21)
    _check(got, _dense_stats(Z, 8.0))


def test_rect_jnp_padding_tokens_match_nothing():
    Z = _tokens(9, 20, 12, 5, lo=0)
    assert (np.asarray(Z) == 0).any()
    th = jnp.float32(4.0)
    ref = distance.row_stats_rect_jnp(Z, Z, th, 5)
    _check(ref, _dense_stats(Z, 4.0))
    _check(_sq(Z, th, 5), _dense_stats(Z, 4.0))
    _check(_kernel(Z, th, 5), _dense_stats(Z, 4.0))


@pytest.mark.parametrize("theta", [0.2, "auto"])
def test_streaming_weights_bucketed(theta):
    """m_true/n_true padding (batch buckets): streaming weights on the
    padded matrix equal dense weights on the exact one."""
    Z = _tokens(13, 50, 29, 21)
    Zp = jnp.pad(Z, ((0, 14), (0, 3)))
    W0, Meff0, th0 = reweight.compute_weights(Z, theta, q=21)
    W1, Meff1, th1 = reweight.compute_weights_streaming(
        Zp, theta, 21, _kernel, m_true=50, n_true=29)
    np.testing.assert_allclose(np.asarray(W1)[:50], np.asarray(W0),
                               rtol=1e-12)
    assert not np.asarray(W1)[50:].any()
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)


def test_dispatch_gpu_maps_to_gpu_formulation():
    f = dispatch.formulation("gpu")
    assert f.platform == "gpu"
    # streaming kernel reweighting; the gemm-scaffold DI (faster on the
    # H100 than the batch-minor core, PERF.md)
    assert f.streaming_row_stats and not f.di_batch_minor


def test_dispatch_cpu_keeps_references():
    f = dispatch.formulation("cpu")
    assert not f.streaming_row_stats and not f.di_batch_minor
    # this process runs on the CPU backend: no injected kernel
    assert dispatch.formulation() == f
    assert dispatch.kernels() == {"row_stats_fn": None}


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron", ""])
def test_dispatch_unknown_platform_raises(platform):
    with pytest.raises(RuntimeError, match="no formulation"):
        dispatch.formulation(platform)


def test_dispatch_gpu_kernels(monkeypatch):
    """On a GPU platform the injected row stats are the Hopper kernel
    (the real device is not needed to resolve the table)."""
    monkeypatch.setattr(dispatch, "formulation",
                        lambda platform=None: dispatch._TABLE["gpu"])
    assert dispatch.kernels()["row_stats_fn"] is row_stats_triton


def test_pipeline_streaming_path_matches_dense(monkeypatch):
    """The single-card pipeline with the streaming row stats (the
    kernel, interpret mode) equals the CPU table (dense reference) on the
    same data."""
    from gaussdca_tpu.api import scores_pipeline

    Z = _tokens(21, 120, 24, 21)
    args = (Z, jnp.float64(0.5), jnp.float64(0.0))
    kw = dict(q=21, score="frob", theta_is_auto=True, dtype=jnp.float64,
              use_pallas=True)
    S0, th0, me0 = scores_pipeline(*args, **kw)
    monkeypatch.setattr(dispatch, "kernels",
                        lambda: {"row_stats_fn": _kernel})
    S1, th1, me1 = scores_pipeline(*args, **kw)
    np.testing.assert_allclose(np.asarray(S1), np.asarray(S0), rtol=1e-12,
                               atol=1e-14)
    assert float(me1) == pytest.approx(float(me0), rel=1e-12)
    assert float(th1) == float(th0)


@pytest.mark.parametrize("theta", [0.2, "auto"])
def test_mesh_row_stats_path(theta):
    """The shard_map mesh path on 8 virtual devices with the GEMM row
    stats per device (use_pallas=True) equals the jnp reference mesh
    path (use_pallas=False) and the single-card dense path."""
    from gaussdca_tpu.parallel import mesh as meshlib
    from gaussdca_tpu.parallel.sharded import run_sharded

    m = meshlib.make_mesh(8, shape=(4, 2))
    Z = np.asarray(_tokens(5, 64, 20, 21))
    out = {}
    for fast in (True, False):
        S, th, me = run_sharded(m, Z, 0.5, theta, q=21, score="frob",
                                dtype=jnp.float64, use_pallas=fast)
        out[fast] = (np.asarray(S), float(th), float(me))
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-10,
                               atol=1e-13)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-12)
    assert out[True][2] == pytest.approx(out[False][2], rel=1e-12)


@pytest.mark.parametrize("M,block", [
    (40, 64),     # T = 1 (single diagonal tile), padding rows
    (300, 64),    # T = 5
    (513, 128),   # T = 5, one padding-heavy tail tile
    (520, 32),    # T = 17
    (1000, 128),  # T = 8
])
def test_kernel_matches_dense(M, block):
    """The kernel's upper-triangle covering (row reductions in slot
    (i, j), column reductions in slot (j, i)) counts every pair once."""
    Z = _tokens(M, M, 37, 21)
    thresh = 9.0
    _check(_kernel(Z, jnp.float32(thresh), 21, block=block),
           _dense_stats(Z, thresh))


@pytest.mark.parametrize("q", [2, 21, 22, 31])
def test_kernel_q_boundaries(q):
    Z = _tokens(q + 100, 96, 40, q)
    _check(_kernel(Z, jnp.float32(7.0), q), _dense_stats(Z, 7.0))


@pytest.mark.parametrize("N,kc", [(5, 16), (37, 16), (64, 32), (70, 32)])
def test_kernel_width_chunks(N, kc):
    """Widths off the kc-token chunk are zero-padded; one or several
    chunks per tile, hamming distances keep the true width."""
    Z = _tokens(N + 1, 70, N, 21)
    thresh = float(max(1, N // 3))
    _check(_kernel(Z, jnp.float32(thresh), 21, kc=kc),
           _dense_stats(Z, thresh))


@pytest.mark.parametrize("theta", [0.0, 0.3, "auto"])
def test_streaming_weights_kernel(theta):
    Z = _tokens(12, 150, 29, 21)
    W0, Meff0, th0 = reweight.compute_weights(Z, theta)
    W1, Meff1, th1 = reweight.compute_weights_streaming(Z, theta, 21,
                                                        _kernel)
    np.testing.assert_allclose(np.asarray(W1), np.asarray(W0), rtol=1e-12)
    np.testing.assert_allclose(float(Meff1), float(Meff0), rtol=1e-12)
    np.testing.assert_allclose(float(th1), float(th0), rtol=1e-12)


def test_kernel_equals_gemm_formulation():
    """Kernel (square) and GEMM formulation (rectangular pieces, the mesh
    path's per-device body) agree exactly, padding tokens included."""
    Z = _tokens(33, 200, 45, 21, lo=0)
    th = jnp.float32(10.0)
    ks = _kernel(Z, th, 21, block=64)
    pieces = [distance.row_stats_xla(Z[a:b], Z, th, 21)
              for a, b in ((0, 70), (70, 200))]
    for k in range(2):
        np.testing.assert_array_equal(
            np.asarray(ks[k]),
            np.concatenate([np.asarray(p[k]) for p in pieces]))


@pytest.mark.parametrize("x64", [False, True])
def test_kernel_lowers_for_cuda(x64):
    """The kernel lowers through Pallas' Triton route for CUDA without a
    card (what the card's compiler then receives), with and without x64
    (the f64 pipeline calls it with x64 on)."""
    Z = jnp.zeros((300, 70), jnp.int8)
    fn = jax.jit(lambda z, t: row_stats_triton(z, t, 21))
    with jax.enable_x64(x64):
        text = fn.trace(Z, jnp.float32(3.0)).lower(
            lowering_platforms=("cuda",)).as_text()
    assert "row_stats_triton" in text and "triton" in text
