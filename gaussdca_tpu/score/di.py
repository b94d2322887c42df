"""Gaussian Direct Information scores.

Implements the contract of DCAUtils ``compute_DI_gauss(mJ, C, q)`` as
consumed at /root/reference/src/GaussDCA.jl:37: for each position pair
(i, j), the DI is the mutual information of the two-site Gaussian "direct"
model whose precision matrix is ``[[A_i, J_ij], [J_ij^T, B_j]]`` with A_i,
B_j chosen so that the model's single-site marginal covariances match the
empirical (pseudocounted) C_ii and C_jj (Baldassi et al. 2014, PLoS ONE
9(3):e92721, Methods).

Closed form (derived from the coupled fixed point
``A = C_ii^-1 + J B^-1 J^T``, ``B = C_jj^-1 + J^T A^-1 J``; validated to
~1e-8 against the golden files small.DIRout*.txt / large.DIRout.txt): with
``lam_k`` the eigenvalues of ``C_ii J_ij C_jj J_ij^T``,

    DI_ij = 1/2 * sum_k log( (1 + sqrt(1 + 4 lam_k)) / 2 )
          = 1/2 * logdet( (I + sqrtm(G)) / 2 ),   G = I + 4 rho rho^T,
            rho = L_i^T J_ij L_j,  C_ii = L_i L_i^T (Cholesky)

(`rho rho^T` is similar to ``C_ii J C_jj J^T`` — same spectrum as the
symmetric-sqrt sandwich, but Cholesky is direct and robust).

Realization — no eigendecomposition (XLA's iterative f64 eigh proved
non-robust on exactly these degenerate spectra):

1. all P = N(N-1)/2 pairs are processed as one flat batch (chunked by
   ``pair_chunk`` via lax.map to bound memory at O(chunk * s^2)),
2. ``sqrtm(G)`` by the trace-scaled Newton–Schulz coupled iteration —
   pure batched matmuls, quadratically convergent, with a convergence-
   monitored while_loop (f64 reaches ~1e-13; validated against the golden
   DI files),
3. one batched Cholesky at the end for ``logdet((I + sqrtm(G))/2)`` (the
   argument is SPD with spectrum >= 1 — perfectly conditioned).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _batch_eye(s: int, shape, dtype):
    return jnp.broadcast_to(jnp.eye(s, dtype=dtype), tuple(shape) + (s, s))


def sqrtm_spd(A: jax.Array, *, tol: float = None,
              max_iters: int = 40) -> jax.Array:
    """Principal square root of a batch [..., s, s] of SPD matrices.

    Trace-scaled Newton–Schulz: with A' = A/c (c = trace, so the spectrum
    of A' lies in (0, 1]), iterate
        T = (3I - Z Y) / 2 ;  Y <- Y T ;  Z <- T Z
    Y -> sqrt(A'), Z -> sqrt(A')^{-1}; matmuls only. The loop exits when
    mean((ZY - I)^2) falls below ``tol`` (dtype-dependent default) or at
    ``max_iters`` (trace scaling needs ~log_2.25(s * cond) + 6 steps).
    """
    s = A.shape[-1]
    dtype = A.dtype
    if tol is None:
        tol = 1e-26 if dtype == jnp.float64 else 1e-12
    c = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None]
    Ap = A / c
    eye = _batch_eye(s, A.shape[:-2], dtype)

    def cond(state):
        _, _, err, k = state
        return jnp.logical_and(err > tol, k < max_iters)

    def body(state):
        Y, Z, _, k = state
        ZY = jnp.einsum("...ij,...jk->...ik", Z, Y)
        T = 0.5 * (3.0 * eye - ZY)
        Y2 = jnp.einsum("...ij,...jk->...ik", Y, T)
        Z2 = jnp.einsum("...ij,...jk->...ik", T, Z)
        err = jnp.mean((ZY - eye) ** 2)
        return Y2, Z2, err, k + 1

    Y, _, _, _ = jax.lax.while_loop(
        cond, body, (Ap, eye, jnp.asarray(jnp.inf, dtype), 0))
    return Y * jnp.sqrt(c)


# Fixed NS iteration count of the non-bm f32 fallback (gemm scaffold).
# utils/flops.py imports this for the fallback-path accounting — change
# it HERE only, like BM_NS_ITERS below.
FALLBACK_NS_ITERS = 28


def sqrtm_spd_fixed(A: jax.Array,
                    iters: int = FALLBACK_NS_ITERS) -> jax.Array:
    """``sqrtm_spd`` with a FIXED, unrolled iteration count (f32 path).

    The while_loop variant reads its convergence scalar back every
    iteration; this one has no data-dependent control flow. Trace-scaled
    NS converges in ~8 iterations on golden-scale data; the default 28
    covers cond(G) up to ~8e6 (NS needs ~log2(cond) + 5 steps; extra
    post-convergence iterations are identity steps).
    """
    s = A.shape[-1]
    dtype = A.dtype
    c = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None]
    Y = A / c
    Z = _batch_eye(s, A.shape[:-2], dtype)
    eye = Z
    for _ in range(iters):
        T = 1.5 * eye - 0.5 * jnp.einsum("...ij,...jk->...ik", Z, Y)
        Y, Z = (jnp.einsum("...ij,...jk->...ik", Y, T),
                jnp.einsum("...ij,...jk->...ik", T, Z))
    return Y * jnp.sqrt(c)


def _chol_logdet(A: jax.Array) -> jax.Array:
    """logdet of a batch of SPD matrices via the Cholesky diagonal."""
    L = jnp.linalg.cholesky(A)
    diag = jnp.diagonal(L, axis1=-2, axis2=-1)
    return 2.0 * jnp.sum(jnp.log(diag), axis=-1)


def site_cholesky(C: jax.Array, q: int) -> jax.Array:
    """Cholesky factor of every diagonal site block C_ii: [N, s, s].

    The site blocks are gathered from a [N, s, Ns] major-dim split of C
    (layout-free view), NOT from the [N, s, N, s] reshape, which XLA
    may materialize for the diagonal einsum with the small s-sized dim
    minor."""
    s = q - 1
    Ns = C.shape[0]
    N = Ns // s
    C3 = C.reshape(N, s, Ns)
    idx = (jnp.arange(N, dtype=jnp.int32)[:, None] * s
           + jnp.arange(s, dtype=jnp.int32)[None, :])      # [N, s]
    Cii = jnp.take_along_axis(C3, idx[:, None, :], axis=2)  # [N, s, s]
    return jnp.linalg.cholesky(Cii)


def _bm_matmul(A: jax.Array, B: jax.Array) -> jax.Array:
    """Batch-minor product C[i,k,:] = sum_j A[i,j,:] * B[j,k,:].

    A, B: [s, s, P] with the pair batch on the MINOR (lane) axis. The j
    contraction is an unrolled add TREE of broadcasts — XLA fuses it
    into one elementwise kernel over [s, s, P], turning each tiny s x s
    matmul into full-width vector FMAs in exact f32. A lax.fori_loop
    with an [s, s, P] carry would round-trip the carry through device
    memory every step instead.
    """
    s = A.shape[1]
    acc = A[:, 0, :][:, None, :] * B[0, :, :][None, :, :]
    for j in range(1, s):
        acc = acc + A[:, j, :][:, None, :] * B[j, :, :][None, :, :]
    return acc


# Fixed Newton-Schulz iteration count of the batch-minor core.
# utils/flops.py derives the per-family FLOP accounting from
# ``bm_ns_iters()`` below — change it HERE only (a drifted copy in
# flops.py once made every DI FLOP/s log wrong). Golden gate on the
# H100 (f32, shipped defaults, the large DI config on the batch-minor
# core): max abs error 7.72e-4 against the 1e-3 tolerance with 100%
# top-10/top-100 overlap, identical at 14 and at 20 iterations. Margin:
# with the min(trace, inf-norm) initial scaling the count covers cond(G)
# up to ~2.25^(iters-6) ~= 660 at 14 (vs 8e4 at 20); G = I + 4 rho rho^T
# >= I bounds cond(G) = lambda_max(G), and golden-scale MSA data
# converges by ~8 iterations. GDCA_DI_NS_ITERS=20 restores the wider
# margin.
BM_NS_ITERS = 14


def bm_ns_iters() -> int:
    """NS iteration count of the batch-minor core (trace-time knob).

    ``GDCA_DI_NS_ITERS`` (integer >= 2) overrides ``BM_NS_ITERS`` for
    A/B measurement — the NS loop is ~65% of the DI-stage HBM traffic
    (3 [s, s, P] matmuls per iteration), so the iteration count is the
    stage's main lever. The default 14 (see BM_NS_ITERS above) with the
    min(trace, inf-norm) initial scaling
    guarantees convergence for cond(G) up to ~2.25^8 ~ 660 when the
    scale bound is tight (worst case /sqrt(s) when the inf-norm
    overshoots); golden-scale data converges at ~8. Like the
    other kernel knobs this is read at TRACE time: set it before the
    first DI call of a shape class, and the flop accounting
    (utils/flops.py) follows it at call time."""
    import os

    v = os.environ.get("GDCA_DI_NS_ITERS", "").strip()
    return int(v) if v.isdigit() and int(v) >= 2 else BM_NS_ITERS


def matmuls_per_lane(iters: int, *, trimmed: bool) -> int:
    """Per-lane [s, s] matmul-equivalents of the DI cores, owned HERE
    so utils/flops.py cannot drift from the executed graph (the same
    coupling rule as BM_NS_ITERS): 2 (rho = Li^T J Lj) + 1 (G = rho
    rho^T) + the Newton-Schulz loop + ~1 (elimination logdet). The
    batch-minor core (``trimmed=True``) skips the identity iteration-1
    matmuls and the dead final Z update — 3*iters - 3 for iters >= 2 —
    while the gemm-scaffold fallback runs the plain 3*iters loop."""
    ns = 3 * iters - 3 if (trimmed and iters >= 2) else 3 * iters
    return 3 + ns + 1


def _di_pairs_bm(Jb: jax.Array, Li: jax.Array, Lj: jax.Array,
                 iters: int = None) -> jax.Array:
    """Batch-minor DI core on batch-MAJOR inputs ([P, s, s] -> [P]).

    Thin wrapper over ``_di_pairs_bm_minor``; prefer the minor-layout
    entry point when the caller can gather into [s, s, P] directly.
    """
    return _di_pairs_bm_minor(jnp.moveaxis(Jb, 0, -1),
                              jnp.moveaxis(Li, 0, -1),
                              jnp.moveaxis(Lj, 0, -1), iters=iters)


def _di_pairs_bm_minor(J: jax.Array, Li: jax.Array, Lj: jax.Array,
                       iters: int = None) -> jax.Array:
    """Batch-minor DI core: the elementwise twin of ``_di_pairs``.

    Inputs [s, s, P] (pair batch on the minor axis). Same math (rho -> G
    -> trace-scaled Newton-Schulz sqrt -> logdet((I + S)/2)/2) but every
    step is fused vector arithmetic instead of batched 20x20 gemms. The
    logdet is unpivoted Gaussian elimination (H is SPD with spectrum
    >= 1, so pivots are safe) instead of a batched tiny Cholesky.
    The NS iteration count is FIXED (golden-scale data converges at ~8
    iterations; see BM_NS_ITERS for the margin) —
    data-independent runtime, no while_loop. Elimination pivots are
    clamped at 0.1 (true pivots are >= 1 for converged S) so an
    under-converged S on a pathological spectrum degrades that pair's
    score instead of NaN-poisoning the whole matrix through APC; the
    clamp must NOT be a tiny floor (e.g. 1e-20) because the elimination
    column divides by the pivot — a tiny pivot blows the column up to
    ~1/clamp and overflows f32 at the next step (see the inline comment
    and docs/MATH.md). Validated against the golden DI files
    through the force_fallback cross-check and chip_smoke.py.
    """
    if iters is None:
        iters = bm_ns_iters()
    s = J.shape[0]
    P0 = J.shape[-1]
    # 128-align the pair axis: identity-padded lanes keep every value
    # finite (DI of an identity triple is just discarded)
    pad = (-P0) % 128
    if pad:
        eye_pad = jnp.broadcast_to(jnp.eye(s, dtype=J.dtype)[:, :, None],
                                   (s, s, pad))
        J = jnp.concatenate([J, eye_pad], axis=-1)
        Li = jnp.concatenate([Li, eye_pad], axis=-1)
        Lj = jnp.concatenate([Lj, eye_pad], axis=-1)
    P = J.shape[-1]
    LiT = Li.swapaxes(0, 1)
    Lj_ = Lj

    rho = _bm_matmul(LiT, _bm_matmul(J, Lj_))
    rhoT = rho.swapaxes(0, 1)
    eye = jnp.eye(s, dtype=J.dtype)[:, :, None]
    G = 4.0 * _bm_matmul(rho, rhoT) + eye

    ar = jnp.arange(s)
    # initial NS scale: any c >= lambda_max(G) keeps the scaled
    # spectrum in (0, 1] (convergence-safe); iterations-to-converge is
    # ~log_2.25(c / lambda_min) + 6, so the TIGHTER bound wins. Both
    # trace and the inf-norm (max abs row sum) bound lambda_max for
    # symmetric PSD G; trace overshoots by up to s (flat spectra), the
    # inf-norm by up to sqrt(s) — their min is never worse than
    # trace scaling alone and saves up to ~log_2.25(s) ~ 3.7
    # iterations of margin. Cost: one extra fused pass over G.
    tr = jnp.sum(G[ar, ar, :], axis=0)
    inf = jnp.max(jnp.sum(jnp.abs(G), axis=1), axis=0)
    c = jnp.minimum(tr, inf)[None, None, :]              # [1, 1, P]
    Y = G / c
    if iters >= 2:
        # Trim the structurally-trivial matmuls (value-exact: an
        # identity bm_matmul is 1.0*x plus 0.0 terms): iteration 1 has
        # Z = I, so Z@Y = Y and T@Z = T — both skipped; the FINAL
        # iteration's Z update feeds only a next T that never comes —
        # dropped. 3*iters matmuls -> 3*iters - 3 (5% of the NS share
        # at the production iters=20).
        T = 1.5 * eye - 0.5 * Y
        Y, Z = _bm_matmul(Y, T), T
        for _ in range(iters - 2):
            T = 1.5 * eye - 0.5 * _bm_matmul(Z, Y)
            Y, Z = _bm_matmul(Y, T), _bm_matmul(T, Z)
        T = 1.5 * eye - 0.5 * _bm_matmul(Z, Y)
        Y = _bm_matmul(Y, T)
    else:
        Z = jnp.broadcast_to(eye, (s, s, P)).astype(J.dtype)
        for _ in range(iters):
            T = 1.5 * eye - 0.5 * _bm_matmul(Z, Y)
            Y, Z = _bm_matmul(Y, T), _bm_matmul(T, Z)
    S = Y * jnp.sqrt(c)

    H = 0.5 * (S + eye)
    H = 0.5 * (H + H.swapaxes(0, 1))
    acc = jnp.zeros((P,), J.dtype)
    for k in range(s):
        # H is SPD with spectrum >= 1 when S converged, so true pivots
        # are >= 1; clamping at 0.1 keeps a hypothetical under-converged
        # pair finite (bad score, not NaN) while also bounding the
        # elimination column below (a tiny clamp like 1e-20 would blow
        # col up to ~1e20 and overflow f32 on the next pivot)
        pivot = jnp.maximum(H[k, k, :], jnp.asarray(0.1, J.dtype))
        acc = acc + jnp.log(pivot)
        col = H[:, k, :] / pivot[None, :]
        H = H - col[:, None, :] * H[k, :, :][None, :, :]
    return 0.5 * acc[:P0]


# where the platform picks the batch-minor core, it engages at and above
# this pair count; smaller batches take the gemm scaffold. Correctness-
# neutral; the value is not yet measured on the H100 (ROADMAP.md lists
# it).
_BM_MIN_PAIRS = 16384


def _di_pairs(Jb: jax.Array, Li: jax.Array, Lj: jax.Array,
              use_pallas: bool = False) -> jax.Array:
    """DI of a flat batch of pairs. Jb, Li, Lj: [P, s, s] -> [P].

    f32 with ``use_pallas`` truthy and P >= _BM_MIN_PAIRS takes the
    batch-minor fused core (``_di_pairs_bm``); otherwise this is the
    reference jnp path — batched gemms + Newton-Schulz (monitored
    while_loop in f64 golden mode, fixed-iteration in f32) + batched
    Cholesky — used for f64, small batches, the GPU's f32 path and the
    force_fallback cross-check.
    """
    if use_pallas and Jb.dtype == jnp.float32 and \
            Jb.shape[0] >= _BM_MIN_PAIRS:
        return _di_pairs_bm(Jb, Li, Lj)
    if Jb.dtype == jnp.float32:
        # fixed unrolled NS: no per-iteration host sync (see
        # sqrtm_spd_fixed); the while_loop stays for f64 golden mode
        return _di_tail_gemm(Jb, Li, Lj, sqrtm_spd_fixed)
    return _di_tail_gemm(Jb, Li, Lj, sqrtm_spd)


def _di_tail_gemm(Jb, Li, Lj, sqrt_fn):
    """The batched-gemm DI scaffold (rho -> G -> sqrt -> logdet),
    parameterized by the matrix-sqrt implementation so the monitored
    (f64) and fixed-iteration (f32) variants share one copy of the
    formula."""
    s = Jb.shape[-1]
    rho = jnp.einsum("pba,pbc,pcd->pad", Li, Jb, Lj)
    G = jnp.einsum("pab,pcb->pac", rho, rho)
    G = 4.0 * G + _batch_eye(s, G.shape[:-2], G.dtype)
    S = sqrt_fn(G)
    half = 0.5 * (S + _batch_eye(s, S.shape[:-2], S.dtype))
    # exact symmetry guard for the final Cholesky
    half = 0.5 * (half + jnp.swapaxes(half, -1, -2))
    ld = _chol_logdet(half)
    # under-convergence guard, mirroring the bm core's pivot clamp: on
    # the fixed-iteration f32 paths a pathological cond(G) can leave S
    # under-converged and (I + S)/2 indefinite, making the batched
    # Cholesky NaN — degrade that pair's score to 0 instead of letting
    # correct_apc propagate the NaN to the entire matrix. Applied ONLY
    # where the pair's INPUTS were finite: a singular covariance NaNs
    # mJ itself, and sanitizing that would hand api._checked_ranking a
    # clean-looking all-zero ranking instead of the ArithmeticError it
    # exists to raise. (A no-op for converged pairs, including the
    # monitored f64 golden path.)
    finite_in = (jnp.isfinite(Jb).all(axis=(-1, -2))
                 & jnp.isfinite(Li).all(axis=(-1, -2))
                 & jnp.isfinite(Lj).all(axis=(-1, -2)))
    ld = jnp.where(finite_in,
                   jnp.nan_to_num(ld, nan=0.0, posinf=0.0, neginf=0.0),
                   ld)
    return 0.5 * ld


def di_pairs_bm_gathered(J4: jax.Array, Lsite: jax.Array,
                         iu, ju, *, pair_chunk: int = 65536,
                         chunk_multiple: int = 1,
                         body=None) -> jax.Array:
    """Batch-minor DI over (iu, ju) pair indices, gathered per chunk.

    The ONE implementation of the transpose + chunked minor-layout
    gather shared by the single-chip (``di_score``) and mesh-sharded
    (``parallel/sharded._di_sharded``) paths: each chunk gathers
    straight into [s, s, chunk] (no batch-major [P, s, s] copy) and runs
    ``body`` (default: the batch-minor core; the mesh path passes its
    shard_map-wrapped twin). Chunks are balanced (no tiny tail slab)
    and sized in multiples of
    ``chunk_multiple`` (the mesh device count, so every per-device slab
    stays equal and large).
    """
    from gaussdca_tpu.utils.chunked import balanced_chunk

    s = J4.shape[1]
    P = len(iu)
    assert P % chunk_multiple == 0, (P, chunk_multiple)
    J4T = J4.transpose(1, 3, 0, 2)          # [s, s, N, N]
    LsT = Lsite.transpose(1, 2, 0)          # [s, s, N]
    body = body or _di_pairs_bm_minor
    per = P // chunk_multiple
    chunk = (per if per <= pair_chunk
             else balanced_chunk(per, pair_chunk, align=128))
    chunk *= chunk_multiple
    outs = []
    for c0 in range(0, P, chunk):
        ii = iu[c0:c0 + chunk]
        jj = ju[c0:c0 + chunk]
        outs.append(body(J4T[:, :, ii, jj], LsT[:, :, ii], LsT[:, :, jj]))
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs)


def _plan_row_block(N: int) -> int:
    """Smallest lane-aligned row block with a bounded tile count.

    Smaller blocks waste fewer diagonal-tile lanes (overhead ~RB/N),
    but the tile loop is unrolled in the graph, so the block count is
    capped at 8 (<= 36 tiles) to bound compile time; RB=128 keeps the
    per-tile lane batch at the batch-minor core's 16384 minimum.

    ``GDCA_DI_RB`` (trace-time, like the other kernel knobs): an
    integer overrides RB outright; ``exact`` picks the EXACT-FIT block
    RB = ceil(N/nb) with nb = clamp(N // 128, 1, 8) — RB need not be a
    power of two, so padding waste nearly vanishes (N=400: Npd 512 ->
    402, total lanes 163840 -> 107736, 1.52x fewer flops; at N >= ~900
    the two plans converge). Per-lane math is lane-independent, so any
    RB gives bit-identical scores. This planner's only consumer is the
    unrolled formulation (``GDCA_DI_TILED=unrolled``)."""
    import os

    mode = os.environ.get("GDCA_DI_RB", "").strip().lower()
    if mode.isdigit() and int(mode) > 0:
        return int(mode)
    if mode == "exact":
        nb = max(1, min(8, N // 128))
        return -(-N // nb)
    return _plan_row_block_po2(N)


def _plan_row_block_po2(N: int) -> int:
    """The env-independent power-of-two row-block plan (<= 8 blocks).

    ``di_score_bm_mapped`` uses this directly: exact-fit RBs can be
    prime, which would force its uniform strip plan down to CB=1 (tiny
    per-step lane batches), and the exact mode's padding saving
    vanishes by N ~ 900 anyway, far below the mapped range."""
    for rb in (128, 256, 512, 1024, 2048):
        if -(-N // rb) <= 8:
            return rb
    return 4096


def _plan_row_block_mapped(N: int, lane_chunk: int) -> int:
    """Row block of ``di_score_bm_mapped``, honoring ``GDCA_DI_RB``.

    An integer override is honored outright (expert knob — the strip
    plan always finds uniform strips). ``exact`` picks the exact-fit
    block RB = ceil(N / nb) with nb = clamp(N // 128, 1, 8) — but ONLY
    when the whole tile fits in a single strip (RB^2 <= lane_chunk):
    there the strip plan has no divisibility constraint, so prime RBs
    are safe, and the padding + diagonal lane waste shrinks (N=400:
    163840 po2 lanes -> 108288, 1.5x fewer flops). Past that fit
    (N > ~2048 at default chunks) a prime RB would collapse the
    uniform strip plan to CB=1 (tiny per-step lane batches), so the po2
    plan stays. Default: po2."""
    import os

    mode = os.environ.get("GDCA_DI_RB", "").strip().lower()
    if mode.isdigit() and int(mode) > 0:
        return int(mode)
    if mode == "exact":
        nb = max(1, min(8, N // 128))
        rb = -(-N // nb)
        if rb * rb <= lane_chunk:
            return rb
    return _plan_row_block_po2(N)


def _tiled_lane_gate(N: int, pair_chunk: int) -> bool:
    """Whether the UNROLLED dense-tile DI formulation stays within the
    gathered path's lane-batch memory bound at this N.

    The tile planner caps the tile COUNT (compile-time bound), so the
    row block — and with it the per-tile [s, s, RB^2] f32 temporaries —
    grows as ~N/8 beyond N=2048 (RB 256 -> 512 -> ...), losing the
    O(pair_chunk) memory bound the gathered path provides. Gate the
    unrolled tiled path on RB^2 <= max(pair_chunk, _BM_MIN_PAIRS);
    beyond it the MAPPED dense-tile path (``di_score_bm_mapped``) takes
    over — NOT the gathered path, whose per-lane gathers grow fastest
    at exactly these widths. An
    explicit GDCA_DI_RB integer override bypasses the gate (expert
    knob: the caller chose the lane batch)."""
    import os

    if os.environ.get("GDCA_DI_RB", "").strip().isdigit():
        return True
    rb = _plan_row_block(N)
    return rb * rb <= max(pair_chunk, _BM_MIN_PAIRS)


def _mapped_worthwhile(N: int, lane_chunk: int) -> bool:
    """Whether the mapped dense-tile DI beats the gathered path at N.

    Mapped computes its diagonal tiles' discarded lanes and the
    position padding; it is chosen where that lane overhead stays at or
    below 2.1x the useful pairs (N=400: 2.05x, N=1000: 1.18x, N=200:
    2.47x). The threshold is q-independent and not yet measured on the
    H100 (ROADMAP.md lists it). An explicit integer ``GDCA_DI_RB``
    forces mapped (the caller chose the lane batch)."""
    import os

    if os.environ.get("GDCA_DI_RB", "").strip().isdigit():
        return True
    # the gate evaluates the lane ratio under the plan the mapped path
    # would actually run (incl. a guarded GDCA_DI_RB=exact)
    RB = _plan_row_block_mapped(N, lane_chunk)
    nb = -(-N // RB)
    nstrips, CB = _mapped_strip_plan(RB, lane_chunk)
    lanes = nb * (nb + 1) // 2 * nstrips * (-(-RB * CB // 128) * 128)
    return lanes <= 2.1 * (N * (N - 1) // 2)


def _mapped_strip_plan(RB: int, lane_chunk: int) -> tuple:
    """(nstrips, CB): uniform column strips of an RB x RB tile with
    RB * CB <= lane_chunk lanes per strip. nstrips is rounded up to a
    divisor of RB so every strip has the same static shape (lax.map
    needs uniform bodies); a solution exists iff RB <= lane_chunk
    (nstrips <= RB), checked explicitly — without the check an
    oversized RB (e.g. a wild GDCA_DI_RB override reaching a direct
    di_score_bm_mapped call) would spin this loop forever."""
    if RB > lane_chunk:
        raise ValueError(
            f"row_block {RB} exceeds lane_chunk {lane_chunk}: even a "
            "single-column strip would break the lane bound")
    nstrips = max(1, -(-RB * RB // lane_chunk))
    while RB % nstrips:
        nstrips += 1
    return nstrips, RB // nstrips


def _strips_to_tiles(strips: jax.Array, T: int, nstrips: int,
                     RB: int, CB: int) -> jax.Array:
    """[T*nstrips, RB, CB] lax.map strip output -> [T, RB, RB] tiles
    (strips are consecutive column slices of each tile)."""
    return strips.reshape(T, nstrips, RB, CB) \
                 .transpose(0, 2, 1, 3).reshape(T, RB, RB)


def _finish_upper_blocks(U: jax.Array, RB: int, N: int) -> jax.Array:
    """Assembled upper-block [Npd, Npd] matrix -> symmetric [N, N].

    Diagonal tiles computed their i >= j lanes too; keep i < j by
    where, NOT multiplication — a self-pair lane can exceed the fixed-
    NS convergence envelope and come back non-finite, and NaN * 0 =
    NaN would leak through S + S.T and, via APC, into every score.
    ONE copy of this NaN-critical mask, shared by the tiled, mapped,
    and sharded-tiled formulations (keeping three copies in sync is
    the drift class that burned the flop accounting twice)."""
    Npd = U.shape[0]
    r = jnp.arange(Npd)
    same_block = (r[:, None] // RB) == (r[None, :] // RB)
    keep = ~same_block | (r[:, None] < r[None, :])
    U = jnp.where(keep, U, jnp.zeros((), U.dtype))
    S = U + U.T
    return S[:N, :N]


def di_score_bm_mapped(J4: jax.Array, Lsite: jax.Array, N: int, *,
                       row_block: int = 0,
                       lane_chunk: int = 65536) -> jax.Array:
    """[N, N] DI via dense tiles streamed through a FIXED lane buffer.

    The wide-N twin of ``di_score_bm_tiled``: same per-lane math —
    scores agree to f32 rounding (the lax.map body is ONE fused XLA
    compilation, so FMA contraction differs ~1 ulp from the unrolled
    path; tests pin the envelope) — but instead of unrolling one
    bm-core call per tile — whose [s, s, RB^2] temporaries grow as
    (N/8)^2 past N=2048 —
    each upper-triangular tile is split into uniform column strips of
    at most ``lane_chunk`` lanes and ALL (tile, strip) bodies run under
    one ``lax.map`` over a precomputed offset grid. Memory stays
    O(lane_chunk * s^2) at any N and the compiled graph holds ONE body
    regardless of tile count (the unrolled path's 36-tile graph bound
    is what forced its RB to grow). Assembly is gather-free per lane:
    strips reshape back into [T, RB, RB] tiles, tiles land in the
    [nb, nb] block grid through a single contiguous BLOCK gather (index
    [nb, nb] into [T+1, RB, RB]; lower blocks pick the appended zero
    block), and the block grid transposes into [Npd, Npd] — the
    scattered per-lane fancy-indexing that made the gathered path
    pathological never appears.

    ``GDCA_DI_RB=exact`` is honored iff the exact-fit block fits one
    uniform strip (RB^2 <= lane_chunk; ``_plan_row_block_mapped``) —
    the single-strip guard makes prime RBs safe; an explicit integer
    override is always honored.
    """
    s = J4.shape[1]
    dtype = J4.dtype
    if not row_block:
        # integer override and guarded exact-fit handled by the shared
        # mapped planner (_plan_row_block_mapped) — the accounting twin
        # planned_lane_count calls the same function
        row_block = _plan_row_block_mapped(N, lane_chunk)
    RB = row_block
    nb = -(-N // RB)
    Npd = nb * RB
    # The coupling stays a FLAT [Npd*s, Npd*s] matrix all the way into
    # the lax.map body; tiles reshape/transpose per strip, so no
    # full-size [s, s, Npd, Npd] transposed copy of the coupling is
    # ever materialized across the loop boundary.
    J2 = J4.reshape(N * s, N * s)                # free view of mJ
    if Npd != N:
        pad = Npd - N
        # zero-padded sites: J blocks 0 -> G = I -> DI = 0 (finite)
        J2 = jnp.pad(J2, ((0, pad * s), (0, pad * s)))
        Lsite = jnp.pad(Lsite, ((0, pad), (0, 0), (0, 0)))
    LsT = Lsite.transpose(1, 2, 0)               # [s, s, Npd] tiny
    nstrips, CB = _mapped_strip_plan(RB, lane_chunk)

    # upper-triangular (tile, strip) offset grid, precomputed on host
    bi, bj = np.triu_indices(nb)
    T = bi.size
    r0s = jnp.asarray(np.repeat(bi * RB, nstrips), jnp.int32)
    c0s = jnp.asarray((np.repeat(bj * RB, nstrips)
                       + np.tile(np.arange(nstrips) * CB, T)), jnp.int32)

    def body(offs):
        r0, c0 = offs
        z = jnp.zeros((), r0.dtype)    # dynamic_slice wants uniform index dtypes
        blk = jax.lax.dynamic_slice(
            J2, (r0 * s, c0 * s), (RB * s, CB * s))
        # [RB*s, CB*s] -> [s, s, RB*CB]: same (i*CB + j) lane order as
        # the J4T-slice formulation (tile-local transpose)
        Jb = (blk.reshape(RB, s, CB, s).transpose(1, 3, 0, 2)
              .reshape(s, s, RB * CB))
        Li = jnp.broadcast_to(
            jax.lax.dynamic_slice(LsT, (z, z, r0), (s, s, RB))[..., None],
            (s, s, RB, CB)).reshape(s, s, RB * CB)
        Lj = jnp.broadcast_to(
            jax.lax.dynamic_slice(LsT, (z, z, c0), (s, s, CB))[:, :, None],
            (s, s, RB, CB)).reshape(s, s, RB * CB)
        return _di_pairs_bm_minor(Jb, Li, Lj).reshape(RB, CB)

    strips = jax.lax.map(body, (r0s, c0s))       # [T*nstrips, RB, CB]
    tiles = _strips_to_tiles(strips, T, nstrips, RB, CB)
    # block-gather assembly: upper (bi, bj) -> its tile, everything
    # else -> the appended zero block (contiguous RB x RB blocks — a
    # regular large-block gather, not per-lane fancy indexing)
    idx = np.full((nb, nb), T, np.int32)
    idx[bi, bj] = np.arange(T, dtype=np.int32)
    tiles = jnp.concatenate(
        [tiles, jnp.zeros((1, RB, RB), dtype)], axis=0)
    U = tiles[jnp.asarray(idx)].transpose(0, 2, 1, 3).reshape(Npd, Npd)
    return _finish_upper_blocks(U, RB, N)


def di_score_bm_tiled(J4: jax.Array, Lsite: jax.Array, N: int, *,
                      row_block: int = 0) -> jax.Array:
    """[N, N] DI via DENSE (row-block x col-block) tiles — no gathers.

    ``di_pairs_bm_gathered`` feeds the batch-minor core through
    per-chunk fancy-indexed gathers of scattered (i, j) lanes; profiled
    at N=1000 the gather + chunk concatenation dominate the DI wall
    (~2.4 s of 3.0 s against a ~0.6 s arithmetic bound). Here the pair
    batch is the upper-triangular TILE grid instead: tile (bi, bj) of
    the [s, s, N, N] transposed coupling view is a contiguous slice
    whose [s, s, RB, RB] block RESHAPES straight into the [s, s, RB*RB]
    lane batch — zero gather, dense writes back into S. Diagonal tiles
    compute their i >= j lanes too (discarded by the upper-triangular
    mask): a RB/N-order flop overhead (~13% at RB=128, N=1000) traded
    for eliminating every gather. ``row_block=0`` auto-plans
    (_plan_row_block: smallest aligned block with <= 36 tiles).

    Per-lane math is identical to the gathered path (lanes are
    independent), so scores are bit-identical where both are defined.
    """
    s = J4.shape[1]
    dtype = J4.dtype
    if row_block == 0:
        row_block = _plan_row_block(N)
    nb = -(-N // row_block)
    Npd = nb * row_block
    if Npd != N:
        pad = Npd - N
        # zero-padded sites: J blocks 0 -> G = I -> DI = 0 (finite)
        J4 = jnp.pad(J4, ((0, pad), (0, 0), (0, pad), (0, 0)))
        Lsite = jnp.pad(Lsite, ((0, pad), (0, 0), (0, 0)))
    J4T = J4.transpose(1, 3, 0, 2)               # [s, s, Npd, Npd]
    LsT = Lsite.transpose(1, 2, 0)               # [s, s, Npd]
    RB = row_block
    S = jnp.zeros((Npd, Npd), dtype)
    for bi in range(nb):
        for bj in range(bi, nb):
            r0, c0 = bi * RB, bj * RB
            Jb = J4T[:, :, r0:r0 + RB, c0:c0 + RB].reshape(s, s, RB * RB)
            Li = jnp.broadcast_to(
                LsT[:, :, r0:r0 + RB, None], (s, s, RB, RB)
            ).reshape(s, s, RB * RB)
            Lj = jnp.broadcast_to(
                LsT[:, :, None, c0:c0 + RB], (s, s, RB, RB)
            ).reshape(s, s, RB * RB)
            di = _di_pairs_bm_minor(Jb, Li, Lj).reshape(RB, RB)
            S = jax.lax.dynamic_update_slice(S, di, (r0, c0))
    # diagonal-tile i >= j lanes (incl. possibly-non-finite self pairs)
    # dropped by the one shared NaN-safe mask
    return _finish_upper_blocks(S, RB, N)


def accounting_plan(N: int, *, pair_chunk: int = 65536,
                    requested_bm: bool = True,
                    sharded: bool = False) -> tuple:
    """(lanes, iters, trimmed) of the DI formulation the dispatch will
    actually EXECUTE — the one accounting mirror utils/flops.py
    consumes. ``requested_bm`` is the caller's coarse gate (the
    platform's batch-minor choice + f32 + kernels on); the
    ``P >= _BM_MIN_PAIRS`` leg of the real gate lives HERE so the
    accounting cannot drift from ``di_score``.

    - sharded (mesh runs): every storage-sharded body feeds exact-P
      lane slabs to the core (the tiled body's strip overhead is
      ndev-dependent and NOT counted — a slight undercount);
    - small P (< ``_BM_MIN_PAIRS``) or non-bm: the gemm scaffold at
      ``FALLBACK_NS_ITERS`` fixed untrimmed iterations.
    """
    P = N * (N - 1) // 2
    bm = requested_bm and P >= _BM_MIN_PAIRS
    if bm and sharded:
        return (planned_lane_count(N, pair_chunk=pair_chunk, bm=True,
                                   mode="0"),
                bm_ns_iters(), True)
    if bm:
        return (planned_lane_count(N, pair_chunk=pair_chunk, bm=True),
                bm_ns_iters(), True)
    return (planned_lane_count(N, pair_chunk=pair_chunk, bm=False),
            FALLBACK_NS_ITERS, False)


def planned_lane_count(N: int, *, pair_chunk: int = 65536,
                       bm: bool = True, mode: str = None) -> int:
    """Lanes the production DI path will actually COMPUTE at width N.

    The flop-accounting twin of ``di_score``'s dispatch (utils/flops.py
    consumes this): the useful pair count is P = N(N-1)/2, but the
    executed lane count differs per formulation —

    - mapped dense-tile (bm DEFAULT at every N, ``di_score_bm_mapped``):
      the nb(nb+1)/2 tile grid (diagonal tiles include their discarded
      i >= j lanes) streamed as nstrips uniform RB x CB strips per
      tile — tiles * nstrips * pad128(RB * CB) lanes;
    - unrolled dense-tile (``GDCA_DI_TILED=unrolled`` A/B knob, within
      ``_tiled_lane_gate``): RB^2 lanes per
      tile, each tile lane-padded to a multiple of 128;
    - gathered bm (`GDCA_DI_TILED=0` A/B knob): exact P lanes in
      balanced chunks, each chunk padded to a multiple of 128;
    - non-bm fallback (``bm=False``: f64 golden mode, small P, CPU):
      exact P lanes in balanced chunks (``di_pairs_flat``) — the chunk
      zero-padding is counted like the gathered path's.

    Honors the same env knobs as the dispatch (GDCA_DI_TILED,
    GDCA_DI_RB) at CALL time, so accounting follows any A/B override;
    ``mode`` overrides the GDCA_DI_TILED read (``accounting_plan``
    passes "0" to count a sharded body's gathered-style lanes without
    touching the environment).
    """
    import os

    def _pad128(x: int) -> int:
        return -(-x // 128) * 128

    P = N * (N - 1) // 2
    if mode is None:
        mode = os.environ.get("GDCA_DI_TILED", "1").lower()
    dense = (bm and P >= _BM_MIN_PAIRS
             and mode not in ("0", "false", "no"))
    if dense:
        lane_chunk = max(pair_chunk, _BM_MIN_PAIRS)
        if mode == "unrolled" and _tiled_lane_gate(N, pair_chunk):
            RB = _plan_row_block(N)
            nb = -(-N // RB)
            return nb * (nb + 1) // 2 * _pad128(RB * RB)
        if mode == "mapped" or _mapped_worthwhile(N, lane_chunk):
            # mapped branch mirrors di_score_bm_mapped's RB choice
            # through the one shared planner (integer override honored,
            # "exact" under the single-strip guard)
            RB = _plan_row_block_mapped(N, lane_chunk)
            nb = -(-N // RB)
            nstrips, CB = _mapped_strip_plan(RB, lane_chunk)
            return nb * (nb + 1) // 2 * nstrips * _pad128(RB * CB)
        # ratio gate fell through to the gathered path: counted below
    from gaussdca_tpu.utils.chunked import balanced_chunk
    chunk = P if P <= pair_chunk else balanced_chunk(P, pair_chunk,
                                                     align=128)
    if not bm:
        # di_pairs_flat zero-pads P to a whole number of chunks; the
        # gemm scaffold has no extra lane alignment
        return -(-P // chunk) * chunk
    full, tail = divmod(P, chunk)
    return full * _pad128(chunk) + (_pad128(tail) if tail else 0)


def di_pairs_flat(Jb: jax.Array, Li: jax.Array, Lj: jax.Array,
                  *, pair_chunk: int = 65536,
                  use_pallas: bool = False) -> jax.Array:
    """DI of a flat batch of coupling blocks: [P, s, s] x3 -> [P].

    The chunked core shared by ``di_score`` and the multi-chip sharded
    pipeline (each device calls this on its own pair slab — the pair
    batch is embarrassingly parallel, zero communication). ``pair_chunk``
    bounds the live set at O(chunk * s^2) via lax.map.
    """
    P = Jb.shape[0]
    s = Jb.shape[-1]
    if P <= pair_chunk:
        return _di_pairs(Jb, Li, Lj, use_pallas)
    # balance the chunks: ceil-split P over the minimum chunk count
    # (lane-aligned) instead of padding the tail to a full pair_chunk
    # — at N=400 naive padding would compute 64% extra pairs
    from gaussdca_tpu.utils.chunked import balanced_chunk
    chunk = balanced_chunk(P, pair_chunk, align=128)
    pad = (-P) % chunk

    def padz(x):
        return jnp.concatenate(
            [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)

    blocks = jax.tree_util.tree_map(
        lambda x: padz(x).reshape(-1, chunk, s, s), (Jb, Li, Lj))
    return jax.lax.map(lambda a: _di_pairs(*a, use_pallas),
                       blocks).reshape(-1)[:P]


def di_score(mJ: jax.Array, C: jax.Array, q: int,
             *, pair_chunk: int = 65536,
             use_pallas: bool = None) -> jax.Array:
    """S [N, N]: Gaussian direct information per position pair.

    ``use_pallas=False`` forces the reference jnp path (monitored
    Newton-Schulz + batched Cholesky — also the f64 golden path).
    Otherwise the platform's formulation (ops/dispatch.py) decides:
    where it picks the batch-minor core, f32 pair batches of at least
    ``_BM_MIN_PAIRS`` run it.
    """
    if use_pallas is not False:
        from gaussdca_tpu.ops import dispatch
        use_pallas = dispatch.formulation().di_batch_minor
    s = q - 1
    Ns = mJ.shape[0]
    N = Ns // s
    J4 = mJ.reshape(N, s, N, s)
    Lsite = site_cholesky(C, q)

    iu, ju = np.triu_indices(N, k=1)
    P = iu.size

    import os
    bm = use_pallas and mJ.dtype == jnp.float32 and P >= _BM_MIN_PAIRS
    if bm:
        # dense-tile formulation by default (no gathers), STREAMED
        # through the fixed lane buffer at every N (O(lane_chunk)
        # memory — never a silent handoff to the gathered path, whose
        # per-lane gathers grow fastest at wide N). GDCA_DI_TILED=0
        # reverts to the chunked gathered path for A/B measurement;
        # =unrolled selects the unrolled per-tile graph.
        mode = os.environ.get("GDCA_DI_TILED", "1").lower()
        if mode not in ("0", "false", "no"):
            # streamed dense tiles wherever their lane overhead is
            # modest (_mapped_worthwhile), with O(lane_chunk) memory;
            # "unrolled" keeps the per-tile graph reachable for A/B
            # within its gate, "mapped" forces the streamed form below
            # the ratio gate.
            lane_chunk = max(pair_chunk, _BM_MIN_PAIRS)
            if mode == "unrolled" and _tiled_lane_gate(N, pair_chunk):
                return di_score_bm_tiled(J4, Lsite, N)
            if mode == "mapped" or _mapped_worthwhile(N, lane_chunk):
                return di_score_bm_mapped(J4, Lsite, N,
                                          lane_chunk=lane_chunk)
        di = di_pairs_bm_gathered(J4, Lsite, iu, ju,
                                  pair_chunk=pair_chunk)
    else:
        Jb = J4[iu, :, ju, :]
        Li = Lsite[iu]
        Lj = Lsite[ju]
        di = di_pairs_flat(Jb, Li, Lj, pair_chunk=pair_chunk,
                           use_pallas=use_pallas)

    S = jnp.zeros((N, N), mJ.dtype)
    S = S.at[iu, ju].set(di)
    S = S.at[ju, iu].set(di)
    return S
