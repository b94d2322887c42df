"""Score-stage unit tests: FN gauge, DI properties, APC, ranking."""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from gaussdca_tpu.score.apc import correct_apc
from gaussdca_tpu.score.di import di_score
from gaussdca_tpu.score.frob import frob_score
from gaussdca_tpu.score.rank import (compute_ranking, format_rank, printrank,
                                     ranking_pairs, top_k_ranking)


def random_spd(n, rng, jitter=0.5):
    A = rng.standard_normal((n, n))
    return jnp.asarray(A @ A.T + jitter * n * np.eye(n))


def test_frob_gauge_invariance():
    # Adding per-row/per-column constants to a coupling block must not
    # change its zero-sum-gauge Frobenius norm.
    q, s, N = 4, 3, 3
    rng = np.random.default_rng(0)
    mJ = rng.standard_normal((N * s, N * s))
    mJ = (mJ + mJ.T) / 2
    S0 = np.asarray(frob_score(jnp.asarray(mJ), q))

    shifted = mJ.copy()
    # shift block (0, 1) by row constants r_a and column constants c_b
    r = rng.standard_normal(s)[:, None]
    c = rng.standard_normal(s)[None, :]
    shifted[0:s, s:2 * s] += r + c
    shifted[s:2 * s, 0:s] = shifted[0:s, s:2 * s].T
    S1 = np.asarray(frob_score(jnp.asarray(shifted), q))
    np.testing.assert_allclose(S1[0, 1], S0[0, 1], rtol=1e-12)


def test_frob_zero_coupling_zero_score():
    q, s, N = 3, 2, 4
    mJ = jnp.asarray(np.kron(np.eye(N), np.ones((s, s))))  # block-diagonal
    S = np.asarray(frob_score(mJ, q))
    offdiag = S - np.diag(np.diag(S))
    np.testing.assert_allclose(offdiag, 0.0, atol=1e-14)


def test_frob_symmetric_zero_diag():
    q, s, N = 4, 3, 5
    rng = np.random.default_rng(1)
    mJ = rng.standard_normal((N * s, N * s))
    mJ = jnp.asarray((mJ + mJ.T) / 2)
    S = np.asarray(frob_score(mJ, q))
    np.testing.assert_allclose(S, S.T, rtol=1e-12)
    np.testing.assert_allclose(np.diag(S), 0.0)


def test_di_zero_coupling_zero_score():
    q, s, N = 3, 2, 3
    rng = np.random.default_rng(2)
    C = random_spd(N * s, rng)
    mJ = jnp.asarray(np.kron(np.eye(N), np.ones((s, s)) + np.eye(s)))
    S = np.asarray(di_score(mJ, C, q))
    offdiag = S - np.diag(np.diag(S))
    np.testing.assert_allclose(offdiag, 0.0, atol=1e-12)


def test_di_nonnegative_symmetric():
    q, s, N = 4, 3, 4
    rng = np.random.default_rng(3)
    C = random_spd(N * s, rng)
    mJ = jnp.linalg.inv(C)
    S = np.asarray(di_score(mJ, C, q))
    assert np.all(S >= -1e-12)
    np.testing.assert_allclose(S, S.T, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.diag(S), 0.0)


def test_di_2site_exact_mutual_information():
    # One pair, s=1: DI must equal the scalar Gaussian MI
    #   -0.5*log(1 - rho^2) of the *direct* model matched to C.
    # Build an exactly 2-site system: then the direct model IS the model,
    # and DI(i,j) = MI(x_i, x_j) computable in closed form from C.
    q, s, N = 2, 1, 2
    c = np.array([[2.0, 0.8], [0.8, 1.0]])
    C = jnp.asarray(c)
    mJ = jnp.linalg.inv(C)
    S = np.asarray(di_score(mJ, C, q))
    rho2 = c[0, 1] ** 2 / (c[0, 0] * c[1, 1])
    expected = -0.5 * np.log(1 - rho2)
    np.testing.assert_allclose(S[0, 1], expected, rtol=1e-10)


def test_apc_matches_reference_formula():
    rng = np.random.default_rng(4)
    N = 7
    S = rng.standard_normal((N, N))
    S = (S + S.T) / 2
    np.fill_diagonal(S, 0.0)
    got = np.asarray(correct_apc(jnp.asarray(S)))
    Si = S.sum(axis=0, keepdims=True)
    Sj = S.sum(axis=1, keepdims=True)
    Sa = S.sum() * (1 - 1 / N)
    np.testing.assert_allclose(got, S - (Sj @ Si) / Sa, rtol=1e-12)


def test_ranking_pair_set_and_source_triangle():
    N, m = 8, 3
    S = np.zeros((N, N))
    # plant asymmetry: ranking must read the LOWER triangle S[j, i]
    S[5, 1] = 7.0   # pair (i=2, j=6) 1-based
    S[1, 5] = -100.0
    R = compute_ranking(S, m)
    assert len(R) == (N - m) * (N - m + 1) // 2
    assert R[0] == (2, 6, 7.0)
    pairs = {(i, j) for i, j, _ in R}
    assert all(j - i >= m for i, j in pairs)
    ii, jj = ranking_pairs(N, m)
    assert pairs == set(zip(ii.tolist(), jj.tolist()))


def test_ranking_sorted_descending():
    rng = np.random.default_rng(5)
    N = 10
    S = rng.standard_normal((N, N))
    R = compute_ranking(S, 2)
    scores = [x for _, _, x in R]
    assert scores == sorted(scores, reverse=True)


def test_top_k_matches_full_ranking_head():
    rng = np.random.default_rng(6)
    N = 12
    S = rng.standard_normal((N, N))
    full = compute_ranking(S, 3)
    top = top_k_ranking(S, 3, 5)
    assert [x[2] for x in top] == [x[2] for x in full[:5]]


def test_printrank_format():
    R = [(11, 35, 3.6494750123), (9, 37, -1.676179e-4)]
    buf = io.StringIO()
    printrank(buf, R)
    assert buf.getvalue() == "11 35 3.649475e+00\n9 37 -1.676179e-04\n"


def test_printrank_to_path(tmp_path):
    p = str(tmp_path / "out.txt")
    printrank(p, [(1, 2, 0.5)])
    assert open(p).read() == "1 2 5.000000e-01\n"


def test_top_k_device_matches_full_ranking():
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score.rank import compute_ranking, top_k_device

    rng = np.random.default_rng(31)
    N, m = 40, 5
    S = rng.standard_normal((N, N))
    S = (S + S.T) / 2
    np.fill_diagonal(S, 0.0)
    full = compute_ranking(S, m)
    for k in (1, 10, 100, 10**6):
        top = top_k_device(jnp.asarray(S), m, k)
        kk = min(k, len(full))
        assert len(top) == kk
        # same pair set and scores as the head of the full ranking
        # (tie order may differ, so compare as score-sorted sets)
        assert {(i, j) for i, j, _ in top} == \
               {(i, j) for i, j, _ in full[:kk]}
        for (i, j, s) in top:
            assert s == pytest.approx(dict(((a, b), v) for a, b, v in full)[
                (i, j)], rel=1e-12)


def test_pipeline_deterministic():
    """Same input -> bitwise identical scores (the reference relies on
    threads + unstable sort; here determinism is an invariant)."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.api import scores_pipeline

    rng = np.random.default_rng(5)
    Z = jnp.asarray(rng.integers(1, 9, size=(48, 20), dtype=np.int8))
    args = (Z, jnp.asarray(0.5, jnp.float64), jnp.asarray(0.2, jnp.float64))
    kw = dict(q=8, score="frob", theta_is_auto=False, dtype=jnp.float64,
              use_pallas=False)
    S1, _, _ = scores_pipeline(*args, **kw)
    S2, _, _ = scores_pipeline(*args, **kw)
    assert np.array_equal(np.asarray(S1), np.asarray(S2))


def test_printrank_stdout(capsys):
    """printrank(R) with output omitted writes to stdout — the documented
    reference behavior (its own implementation of this arm was broken)."""
    from gaussdca_tpu.score.rank import printrank
    printrank([(1, 7, 2.5), (2, 9, -0.125)])
    outp = capsys.readouterr().out
    assert outp == "1 7 2.500000e+00\n2 9 -1.250000e-01\n"


def test_sqrtm_spd_fixed_matches_monitored():
    """The fixed-iteration f32 Newton-Schulz square root (the gemm
    scaffold's f32 path) agrees with the monitored f64 iteration."""
    import jax
    from gaussdca_tpu.score.di import sqrtm_spd, sqrtm_spd_fixed

    rng = np.random.default_rng(5)
    P, s = 130, 20
    A = rng.standard_normal((P, s, s)).astype(np.float32)
    G = jnp.asarray(np.einsum("pij,pkj->pik", A, A) / s +
                    np.eye(s, dtype=np.float32))
    want = np.asarray(sqrtm_spd(G.astype(jnp.float64))).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(sqrtm_spd_fixed(G))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # and it is a square root
    np.testing.assert_allclose(np.einsum("pij,pjk->pik", got, got),
                               np.asarray(G), rtol=2e-4, atol=2e-4)


def test_di_batch_minor_matches_reference_path():
    """The f32 batch-minor fused DI core must match the reference jnp
    path (monitored NS + batched Cholesky) to f32 round-off — the
    force_fallback cross-check pattern applied to the DI tail."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score.di import _di_pairs, _di_pairs_bm

    rng = np.random.default_rng(4)
    s, P = 20, 300
    Jb = jnp.asarray(rng.standard_normal((P, s, s)).astype(np.float32)
                     * 0.05)

    def mkL(seed):
        r = np.random.default_rng(seed)
        M = r.standard_normal((P, s, s)).astype(np.float32) * 0.1
        C = np.einsum("pab,pcb->pac", M, M) + np.eye(s, dtype=np.float32)
        return jnp.asarray(np.linalg.cholesky(C))

    Li, Lj = mkL(5), mkL(6)
    want = np.asarray(_di_pairs(Jb, Li, Lj, use_pallas=False))
    got = np.asarray(_di_pairs_bm(Jb, Li, Lj))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_di_batch_minor_small_s():
    """q=2 edge (s=1): the batch-minor core must handle 1x1 blocks."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score.di import _di_pairs, _di_pairs_bm

    rng = np.random.default_rng(7)
    P = 40
    Jb = jnp.asarray(rng.standard_normal((P, 1, 1)).astype(np.float32))
    Li = jnp.asarray(
        np.abs(rng.standard_normal((P, 1, 1))).astype(np.float32) + 0.5)
    Lj = jnp.asarray(
        np.abs(rng.standard_normal((P, 1, 1))).astype(np.float32) + 0.5)
    want = np.asarray(_di_pairs(Jb, Li, Lj, use_pallas=False))
    got = np.asarray(_di_pairs_bm(Jb, Li, Lj))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_di_tiled_matches_gathered():
    """The dense-tile DI formulation (di_score_bm_tiled — zero gathers)
    must be LANE-IDENTICAL to the chunked gathered batch-minor path and
    f32-close to the reference jnp path, including N not divisible by
    the tile and the diagonal-tile masking."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score.di import (di_pairs_bm_gathered, di_score,
                                       di_score_bm_tiled, site_cholesky)

    q, N = 6, 75                      # Npd = 128 > N: padding engaged
    s = q - 1
    Ns = N * s
    rng = np.random.default_rng(11)
    A = rng.standard_normal((Ns, Ns)).astype(np.float32) * 0.1
    C = jnp.asarray(A @ A.T / Ns + np.eye(Ns, dtype=np.float32))
    from gaussdca_tpu.solve.cholesky import spd_inverse
    mJ = spd_inverse(C.astype(jnp.float64)).astype(jnp.float32)

    J4 = mJ.reshape(N, s, N, s)
    Lsite = site_cholesky(C, q)
    S_tiled = np.asarray(di_score_bm_tiled(J4, Lsite, N, row_block=128))

    iu, ju = np.triu_indices(N, k=1)
    di = np.asarray(di_pairs_bm_gathered(J4, Lsite, iu, ju))
    S_gath = np.zeros((N, N), np.float32)
    S_gath[iu, ju] = di
    S_gath = S_gath + S_gath.T

    # same core, same lanes -> bitwise-equal scores
    np.testing.assert_array_equal(S_tiled, S_gath)
    assert np.all(np.diag(S_tiled) == 0.0)

    # lane math is lane-independent: any row block — including a
    # non-power-of-two exact-fit one with padding (RB=38: Npd=76) —
    # must stay bitwise-equal
    S_odd = np.asarray(di_score_bm_tiled(J4, Lsite, N, row_block=38))
    np.testing.assert_array_equal(S_odd, S_gath)

    S_ref = np.asarray(di_score(mJ, C, q, use_pallas=False))
    np.testing.assert_allclose(S_tiled, S_ref, rtol=2e-4, atol=2e-5)


def test_di_tiled_row_block_plan(monkeypatch):
    """Auto-plan: smallest aligned block with <= 8 row blocks (bounded
    unroll), so diagonal-tile lane waste (~RB/N) stays small at the
    shapes that matter."""
    from gaussdca_tpu.score.di import _plan_row_block

    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    assert _plan_row_block(200) == 128
    assert _plan_row_block(1000) == 128
    assert _plan_row_block(1024) == 128
    assert _plan_row_block(1200) == 256
    assert _plan_row_block(4000) == 512

    monkeypatch.setenv("GDCA_DI_RB", "exact")
    assert _plan_row_block(400) == 134    # nb=3, Npd=402 (was 512)
    assert _plan_row_block(1000) == 143   # nb=7, Npd=1001
    assert _plan_row_block(1024) == 128   # nb=8: exact fit
    assert _plan_row_block(200) == 200    # nb=1: single diagonal tile
    assert _plan_row_block(4000) == 500   # nb capped at 8

    monkeypatch.setenv("GDCA_DI_RB", "192")
    assert _plan_row_block(1000) == 192   # integer override wins


def test_tiled_lane_gate(monkeypatch):
    """The dense-tile DI default must keep the gathered path's memory
    bound: once the planner's capped tile count pushes RB^2 past
    max(pair_chunk, 16384) lanes per tile, di_score switches from the
    unrolled tiled path to the lax.map-streamed mapped path (NOT the
    gathered path — round-3 verdict weak #6). An explicit GDCA_DI_RB
    integer override bypasses the gate (the caller chose the lane
    batch)."""
    from gaussdca_tpu.score.di import _tiled_lane_gate

    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    assert _tiled_lane_gate(1000, 65536)       # RB=128 -> 16384 lanes
    assert _tiled_lane_gate(2048, 65536)       # RB=256 -> 65536 lanes
    assert not _tiled_lane_gate(2049, 65536)   # RB=512 -> 262144 lanes
    assert not _tiled_lane_gate(4096, 65536)
    # shrinking pair_chunk below the bm core's 16384 minimum never
    # disables RB=128 tiles
    assert _tiled_lane_gate(1000, 1024)
    assert not _tiled_lane_gate(1200, 16384)   # RB=256 over a small chunk

    monkeypatch.setenv("GDCA_DI_RB", "512")
    assert _tiled_lane_gate(2049, 65536)       # explicit override wins


def test_mapped_strip_plan():
    """Uniform strips: RB * CB <= lane_chunk, nstrips divides RB (every
    lax.map body gets the same static shape), full tile covered."""
    from gaussdca_tpu.score.di import _mapped_strip_plan

    for RB, lc in ((128, 65536), (256, 65536), (512, 65536),
                   (1024, 65536), (2048, 65536), (4096, 65536),
                   (512, 16384), (4096, 16384), (192, 10000)):
        nstrips, CB = _mapped_strip_plan(RB, lc)
        assert RB % nstrips == 0
        assert nstrips * CB == RB
        assert RB * CB <= lc
    # one strip when the whole tile fits
    assert _mapped_strip_plan(128, 65536) == (1, 128)
    # RB^2 = 4 * lane_chunk -> 4 uniform strips
    assert _mapped_strip_plan(512, 65536) == (4, 128)


def test_di_mapped_matches_tiled():
    """di_score_bm_mapped (the wide-N streamed dense-tile path) must
    match the unrolled tiled path and the gathered path to f32
    rounding: same per-lane math, only the batching differs (the
    lax.map body is one fused compilation, so FMA contraction shifts
    results ~1 ulp vs the eager paths — a misplaced strip or tile
    would instead show O(value) errors). Exercised with multiple tiles
    AND multiple strips per tile (lane_chunk smaller than RB^2), plus
    N % RB != 0 padding."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score.di import (di_pairs_bm_gathered,
                                       di_score_bm_mapped,
                                       di_score_bm_tiled, site_cholesky)

    q, N = 6, 75
    s = q - 1
    Ns = N * s
    rng = np.random.default_rng(11)
    A = rng.standard_normal((Ns, Ns)).astype(np.float32) * 0.1
    C = jnp.asarray(A @ A.T / Ns + np.eye(Ns, dtype=np.float32))
    from gaussdca_tpu.solve.cholesky import spd_inverse
    mJ = spd_inverse(C.astype(jnp.float64)).astype(jnp.float32)

    J4 = mJ.reshape(N, s, N, s)
    Lsite = site_cholesky(C, q)

    iu, ju = np.triu_indices(N, k=1)
    di = np.asarray(di_pairs_bm_gathered(J4, Lsite, iu, ju))
    S_gath = np.zeros((N, N), np.float32)
    S_gath[iu, ju] = di
    S_gath = S_gath + S_gath.T

    tol = dict(rtol=1e-5, atol=1e-6)   # ~4 ulp at the logdet magnitude

    # default plan (RB=128 -> one tile), strips forced by a small
    # lane_chunk: 16384 lanes / 4096 -> 4 strips of [128, 32]
    S_map = np.asarray(di_score_bm_mapped(J4, Lsite, N, lane_chunk=4096))
    np.testing.assert_allclose(S_map, S_gath, **tol)
    assert np.all(np.diag(S_map) == 0.0)
    assert np.array_equal(S_map, S_map.T)

    # multi-tile grid (RB=32 -> nb=3, T=6 upper tiles) x multi-strip
    # (1024 lanes / 512 -> 2 strips), padding engaged (Npd=96 > 75)
    S_mt = np.asarray(di_score_bm_mapped(J4, Lsite, N, row_block=32,
                                         lane_chunk=512))
    np.testing.assert_allclose(S_mt, S_gath, **tol)

    # whole-tile strips (lane_chunk >= RB^2) match the unrolled path
    S_tiled = np.asarray(di_score_bm_tiled(J4, Lsite, N, row_block=64))
    S_m1 = np.asarray(di_score_bm_mapped(J4, Lsite, N, row_block=64,
                                         lane_chunk=65536))
    np.testing.assert_allclose(S_m1, S_tiled, **tol)

    # and the f32 envelope vs the reference jnp path (as the tiled test)
    from gaussdca_tpu.score.di import di_score
    S_ref = np.asarray(di_score(mJ, C, q, use_pallas=False))
    np.testing.assert_allclose(S_map, S_ref, rtol=2e-4, atol=2e-5)


def test_di_mapped_exact_rb_guarded(monkeypatch):
    """GDCA_DI_RB=exact reaches the mapped planner ONLY under the
    single-strip guard (RB^2 <= lane_chunk, where prime RBs are safe —
    no strip-divisibility constraint); past the guard a prime exact-fit
    RB would collapse the uniform strip plan to CB=1, the measured
    small-lane-batch pathology, so the po2 plan stays. Scores must be
    invariant to the RB choice (per-lane math is lane-independent).
    planned_lane_count mirrors every choice."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score import di

    q, N = 3, 36
    s = q - 1
    Ns = N * s
    rng = np.random.default_rng(5)
    A = rng.standard_normal((Ns, Ns)).astype(np.float32) * 0.1
    C = jnp.asarray(A @ A.T / Ns + np.eye(Ns, dtype=np.float32))
    from gaussdca_tpu.solve.cholesky import spd_inverse
    mJ = spd_inverse(C.astype(jnp.float64)).astype(jnp.float32)
    J4 = mJ.reshape(N, s, N, s)
    Lsite = di.site_cholesky(C, q)

    # within the guard: exact gives RB=36 (single 36x36 tile), po2
    # gives 128 — same scores to f32 rounding (different lane
    # partition, same per-lane math)
    monkeypatch.setenv("GDCA_DI_RB", "exact")
    assert di._plan_row_block_mapped(N, 65536) == 36
    S_exact_env = np.asarray(di.di_score_bm_mapped(J4, Lsite, N))
    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    assert di._plan_row_block_mapped(N, 65536) == 128
    S_plain = np.asarray(di.di_score_bm_mapped(J4, Lsite, N))
    np.testing.assert_allclose(S_exact_env, S_plain, rtol=1e-5,
                               atol=1e-6)

    # past the guard (N=2500: exact RB=313, 313^2 > 65536) the mapped
    # planner and its accounting fall back to the po2 plan
    monkeypatch.setenv("GDCA_DI_RB", "exact")
    assert di._plan_row_block_mapped(2500, 65536) == 512
    lanes_exact_env = di.planned_lane_count(2500, pair_chunk=65536)
    monkeypatch.delenv("GDCA_DI_RB", raising=False)
    lanes_plain = di.planned_lane_count(2500, pair_chunk=65536)
    assert lanes_exact_env == lanes_plain
    # N=2500: po2 RB=512, nb=5, 15 tiles, 4 strips of [512, 128]
    assert lanes_plain == 15 * 4 * 512 * 128

    # within the guard the accounting follows the exact plan (N=400:
    # nb=3, RB=134, 6 tiles of pad128(134^2) = 18048 lanes)
    monkeypatch.setenv("GDCA_DI_RB", "exact")
    assert di.planned_lane_count(400, pair_chunk=65536) == 6 * 18048

    # integer override: the gate passes (caller chose the lane batch),
    # so the UNROLLED tiled path is accounted at that RB
    monkeypatch.setenv("GDCA_DI_RB", "256")
    nb = -(-2500 // 256)
    assert (di.planned_lane_count(2500, pair_chunk=65536)
            == nb * (nb + 1) // 2 * 256 * 256)


def test_di_mapped_assembly_fuzz():
    """Assembly sweep: random couplings at s=2 across irregular
    (N, row_block, lane_chunk) combos — padding, multi-tile grids, and
    multi-strip streaming must all land every lane in the right (i, j)
    cell (a misplaced strip/tile shows O(value) errors, far above the
    f32 rounding envelope asserted here)."""
    import numpy as np
    import jax.numpy as jnp
    from gaussdca_tpu.score.di import (di_pairs_bm_gathered,
                                       di_score_bm_mapped, site_cholesky)
    from gaussdca_tpu.solve.cholesky import spd_inverse

    q = 3
    s = q - 1
    rng = np.random.default_rng(123)
    for N, RB, lc in ((37, 16, 128), (64, 16, 64), (50, 32, 256),
                      (33, 8, 32), (96, 32, 2048)):
        Ns = N * s
        A = rng.standard_normal((Ns, Ns)).astype(np.float32) * 0.1
        C = jnp.asarray(A @ A.T / Ns + np.eye(Ns, dtype=np.float32))
        mJ = spd_inverse(C.astype(jnp.float64)).astype(jnp.float32)
        J4 = mJ.reshape(N, s, N, s)
        Lsite = site_cholesky(C, q)

        iu, ju = np.triu_indices(N, k=1)
        di = np.asarray(di_pairs_bm_gathered(J4, Lsite, iu, ju))
        S_gath = np.zeros((N, N), np.float32)
        S_gath[iu, ju] = di
        S_gath += S_gath.T

        S_map = np.asarray(di_score_bm_mapped(J4, Lsite, N, row_block=RB,
                                              lane_chunk=lc))
        np.testing.assert_allclose(S_map, S_gath, rtol=1e-5, atol=1e-6,
                                   err_msg=f"N={N} RB={RB} lc={lc}")


def test_mapped_strip_plan_rejects_oversized_rb():
    """An RB above lane_chunk has no uniform strip solution — must be a
    ValueError, not an infinite planner loop (round-4 review finding)."""
    from gaussdca_tpu.score.di import _mapped_strip_plan

    with pytest.raises(ValueError):
        _mapped_strip_plan(2048, 1024)


def test_bm_ns_trim_is_exact():
    """The trimmed NS loop (identity iteration 1, dropped final Z
    update) is value-exact vs the plain 3-matmuls-per-iteration loop:
    an identity _bm_matmul is 1.0*x plus 0.0 terms."""
    from gaussdca_tpu.score import di

    rng = np.random.default_rng(17)
    s, P = 6, 256
    J = rng.standard_normal((s, s, P)).astype(np.float32) * 0.2
    J = 0.5 * (J + J.swapaxes(0, 1))
    L = np.tril(rng.standard_normal((s, s, P)).astype(np.float32) * 0.3)
    idx = np.arange(s)
    L[idx, idx] = np.abs(L[idx, idx]) + 1.0
    Jd, Ld = jnp.asarray(J), jnp.asarray(L)

    got = np.asarray(di._di_pairs_bm_minor(Jd, Ld, Ld, iters=8))

    # plain-loop reference: same math, no trimming
    eye = jnp.eye(s, dtype=Jd.dtype)[:, :, None]
    LiT = Ld.swapaxes(0, 1)
    rho = di._bm_matmul(LiT, di._bm_matmul(Jd, Ld))
    G = 4.0 * di._bm_matmul(rho, rho.swapaxes(0, 1)) + eye
    # same min(trace, inf-norm) initial scale as the production core
    c = jnp.minimum(jnp.sum(G[idx, idx, :], axis=0),
                    jnp.max(jnp.sum(jnp.abs(G), axis=1), axis=0)
                    )[None, None, :]
    Y = G / c
    Z = jnp.broadcast_to(eye, G.shape).astype(Jd.dtype)
    for _ in range(8):
        T = 1.5 * eye - 0.5 * di._bm_matmul(Z, Y)
        Y, Z = di._bm_matmul(Y, T), di._bm_matmul(T, Z)
    S = Y * jnp.sqrt(c)
    H = 0.5 * (S + eye)
    H = 0.5 * (H + H.swapaxes(0, 1))
    acc = jnp.zeros((G.shape[-1],), Jd.dtype)
    for k in range(s):
        pivot = jnp.maximum(H[k, k, :], jnp.asarray(0.1, Jd.dtype))
        acc = acc + jnp.log(pivot)
        col = H[:, k, :] / pivot
        H = H - col[:, None, :] * H[k, None, :, :]
        H = H.at[k, :, :].set(0.0).at[:, k, :].set(0.0)
    want = np.asarray(0.5 * acc)

    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7)


def test_bm_ns_scale_bound_dominates_spectrum():
    """The batch-minor core's initial NS scale c = min(trace, inf-norm)
    must bound lambda_max(G) (convergence requires scaled spectrum in
    (0, 1]) while being no larger than the round-2 trace scale (it can
    only tighten the convergence margin, never loosen it)."""
    rng = np.random.default_rng(11)
    s, P = 20, 64
    # spread of conditioning: near-identity through strongly coupled
    for scale in (0.01, 0.3, 3.0):
        R = rng.standard_normal((P, s, s)).astype(np.float64) * scale
        G = 4.0 * np.einsum("pab,pcb->pac", R, R) + np.eye(s)
        lam_max = np.linalg.eigvalsh(G).max(axis=1)
        tr = np.trace(G, axis1=1, axis2=2)
        inf = np.abs(G).sum(axis=2).max(axis=1)
        c = np.minimum(tr, inf)
        assert (c >= lam_max - 1e-9).all()
        assert (c <= tr + 1e-12).all()


def test_di_ns_iters_knob(monkeypatch):
    """GDCA_DI_NS_ITERS drives the executed iteration count: at a
    well-conditioned scale, 8 knob-driven iterations already match the
    reference path (convergence), and an absurd knob value (below the
    quadratic-convergence horizon for this spectrum) visibly degrades
    — proving the knob reaches the loop, not just the accounting."""
    import jax.numpy as jnp
    from gaussdca_tpu.score import di

    rng = np.random.default_rng(4)
    s, P = 20, 300
    Jb = jnp.asarray(rng.standard_normal((P, s, s)).astype(np.float32)
                     * 0.05)

    def mkL(seed):
        r = np.random.default_rng(seed)
        M = r.standard_normal((P, s, s)).astype(np.float32) * 0.1
        C = np.einsum("pab,pcb->pac", M, M) + np.eye(s, dtype=np.float32)
        return jnp.asarray(np.linalg.cholesky(C))

    Li, Lj = mkL(5), mkL(6)
    want = np.asarray(di._di_pairs(Jb, Li, Lj, use_pallas=False))

    monkeypatch.setenv("GDCA_DI_NS_ITERS", "8")
    got8 = np.asarray(di._di_pairs_bm(Jb, Li, Lj))
    np.testing.assert_allclose(got8, want, rtol=2e-4, atol=2e-5)

    monkeypatch.setenv("GDCA_DI_NS_ITERS", "2")
    got2 = np.asarray(di._di_pairs_bm(Jb, Li, Lj))
    assert np.abs(got2 - want).max() > 10 * np.abs(got8 - want).max()

    # junk/low values fall back to the default constant
    monkeypatch.setenv("GDCA_DI_NS_ITERS", "1")
    assert di.bm_ns_iters() == di.BM_NS_ITERS
    monkeypatch.setenv("GDCA_DI_NS_ITERS", "banana")
    assert di.bm_ns_iters() == di.BM_NS_ITERS
