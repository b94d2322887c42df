"""Multi-card sharded gDCA pipeline (shard_map + GSPMD).

Scale-out design (new — the reference is single-process, SURVEY.md 2.9):

- sequences (M) are DATA-parallel across ALL mesh devices for the O(M^2)
  reweighting stage: each device holds its row block plus the full token
  matrix (tokens are int8 and tiny — 40 MB at M=1e5) and computes its
  rows' match-sum / neighbor-count with the rectangular row statistics
  of ops/. Output is O(M_local) per device; the M x M match matrix
  NEVER exists, matching the single-card streaming path, so 1e5+-sequence MSAs shard
  cleanly (a dense D would be 40 GB at M=1e5),
- weighted frequencies are partial-summed per device from local rows
  (chunked one-hot matmuls) and merged with one psum,
- the N*s statistical dimension is MODEL-parallel for covariance
  assembly and scoring (row-sharded over the ``model`` axis),
- the dense Cholesky solve replicates below ``solve_min_dim`` (XLA has no
  distributed Cholesky) and switches to the storage-sharded
  factorization of solve/distributed.py above it — C, L, inv(L), and mJ
  stay 1-D row-sharded end to end, so per-device memory is
  O((Ns)^2/ndev) and the solvable Ns grows with the mesh,
- the DI pair batch (the expensive score: P = N(N-1)/2 independent
  s x s Gaussian integrals, /root/reference/src/GaussDCA.jl:37) is
  sharded over ALL mesh devices — each device integrates only its own
  pair slab, zero communication.

shard_map is used where the per-device program is the point (local
row statistics, partial sums, pair slabs); plain sharding constraints +
GSPMD everywhere else.

``m_true`` / ``n_true`` are TRACED scalars (the unpadded sequence /
position counts), so one compiled program serves a whole
(M-bucket, N-bucket) shape class in batch mode, exactly like the
single-chip path (api.py).
"""

from __future__ import annotations

import functools
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gaussdca_tpu.ops import distance
from gaussdca_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
from gaussdca_tpu.score.apc import correct_apc
from gaussdca_tpu.score.di import di_pairs_flat, site_cholesky
from gaussdca_tpu.score.frob import _fn_row
from gaussdca_tpu.solve.cholesky import spd_inverse
from gaussdca_tpu.solve.distributed import spd_inverse_dist
from gaussdca_tpu.stats import reweight
from gaussdca_tpu.stats.frequencies import accumulate_frequencies
from gaussdca_tpu.stats.pseudocount import add_pseudocount, compute_C


def _constrain(x, spec):
    return jax.lax.with_sharding_constraint(x, spec)


def _row_stats_local(q: int, fast: bool):
    """Per-device body: row stats of the local row block vs all rows
    (int8 one-hot GEMMs when ``fast``, the broadcast-compare reference
    otherwise)."""
    def body(Z_local, Z_full, thresh):
        if fast:
            return distance.row_stats_xla(Z_local, Z_full, thresh, q)
        return distance.row_stats_rect_jnp(Z_local, Z_full, thresh, q)
    return body


def _freq_partial(q: int, dtype, m_chunk: int):
    """Per-device body: unnormalized Pi/Pij partial sums of local rows,
    psum-merged (the accumulator itself is shared with the single-chip
    path — stats/frequencies.accumulate_frequencies)."""
    def body(Z_local, W_local):
        pi, pij = accumulate_frequencies(
            Z_local, W_local.reshape(-1), q, dtype=dtype, m_chunk=m_chunk)
        pi = jax.lax.psum(pi, (DATA_AXIS, MODEL_AXIS))
        pij = jax.lax.psum(pij, (DATA_AXIS, MODEL_AXIS))
        return pi, pij
    return body


def _di_sharded(mesh: Mesh, mJ, C, q: int, *, use_pallas: bool = False,
                pair_chunk: int = 65536):
    """DI score matrix with the pair batch sharded over all mesh devices.

    The P = N(N-1)/2 pair integrals are embarrassingly parallel: the
    (replicated, small) J blocks and site Cholesky factors are gathered
    into a flat pair batch, split over every mesh axis, and each device
    runs the chunked batched integrals on its own slab — no
    communication until the final (tiny) [N, N] scatter. Padding pairs
    reuse index (0, 0); their integrals are computed (1/ndev overhead at
    most) and discarded.

    Where the platform picks the batch-minor core, large f32 batches
    gather straight into batch-MINOR layout ([s, s, P], pairs on the
    minor axis) and run it per device (score/di._di_pairs_bm_minor).

    Kernel-family gate: the batch-minor core engages on the PER-DEVICE
    slab size (Pp // ndev >= _BM_MIN_PAIRS) — small per-device
    batch-minor graphs are a measured runtime pathology (score/di.py)
    — while the single-chip ``di_score`` gates on total P (its ndev is
    1, so it is the same per-device rule). Consequence: a mid-size
    family can take the bm core on one chip but the batched-gemm path
    on a mesh; both are exact f32 of the same formula, so mesh vs
    single-chip scores then differ only by floating-point summation
    order (tests compare with tolerances for exactly this reason).
    """
    from gaussdca_tpu.score.di import (_BM_MIN_PAIRS, _di_pairs_bm_minor,
                                       di_pairs_bm_gathered)

    s = q - 1
    N = mJ.shape[0] // s
    J4 = mJ.reshape(N, s, N, s)
    Lsite = site_cholesky(C, q)

    iu, ju = np.triu_indices(N, k=1)
    Pn = iu.size
    ndev = mesh.devices.size
    Pp = -(-Pn // ndev) * ndev
    iu_p = np.concatenate([iu, np.zeros(Pp - Pn, iu.dtype)])
    ju_p = np.concatenate([ju, np.zeros(Pp - Pn, ju.dtype)])

    dev_axes = (DATA_AXIS, MODEL_AXIS)
    # same gate as di_score, on the per-device slab
    bm = (use_pallas and mJ.dtype == jnp.float32
          and Pp // ndev >= _BM_MIN_PAIRS)
    if bm:
        # the shared chunked minor-layout gather (score/di.py), with
        # each chunk's per-device slab balanced and ndev-aligned; the
        # per-chunk body is the shard_map-wrapped bm core, so the
        # replicated pre-reshard slabs stay bounded at wide N
        body = shard_map(
            _di_pairs_bm_minor, mesh=mesh,
            in_specs=(P(None, None, dev_axes),) * 3,
            out_specs=P(dev_axes), check_vma=False)
        di = di_pairs_bm_gathered(J4, Lsite, iu_p, ju_p,
                                  pair_chunk=pair_chunk,
                                  chunk_multiple=ndev, body=body)
    else:
        Jb = J4[iu_p, :, ju_p, :]
        Li = Lsite[iu_p]
        Lj = Lsite[ju_p]
        body = functools.partial(di_pairs_flat, pair_chunk=pair_chunk,
                                 use_pallas=use_pallas)
        di = shard_map(
            body, mesh=mesh,
            in_specs=(P(dev_axes, None, None),) * 3,
            out_specs=P(dev_axes), check_vma=False)(Jb, Li, Lj)
    di = di[:Pn]

    S = jnp.zeros((N, N), mJ.dtype)
    S = S.at[iu, ju].set(di)
    S = S.at[ju, iu].set(di)
    return S


def _pair_assignment(N: int, ndev: int):
    """Static pair -> device assignment for the locally-gathered DI.

    With mJ row-sharded, the device holding site row-block of i already
    holds the s x s coupling block J_ij for EVERY j (a row of J4 spans
    all columns), so a pair can be scored with zero communication by
    whichever device owns either endpoint's row block. Assignment rule:
    anchor = i when (i + j) is even, else j — deterministic and
    near-uniform (each device gets ~P/ndev pairs +- O(N/ndev)).

    Returns per-device arrays padded to a common lane-aligned Pmax:
    local anchor row, global anchor / other site, the (i, j) scatter
    coordinates, and a validity mask (padding slots gather block
    (anchor_local=0, other=0) — real, finite values — and are masked
    out of the scatter).
    """
    nloc = -(-N // ndev)
    iu, ju = np.triu_indices(N, k=1)
    use_i = ((iu + ju) % 2) == 0
    anchor = np.where(use_i, iu, ju)
    other = np.where(use_i, ju, iu)
    owner = anchor // nloc
    counts = np.bincount(owner, minlength=ndev)
    pmax = max(1, -(-int(counts.max()) // 128) * 128)
    shape = (ndev, pmax)
    li = np.zeros(shape, np.int32)
    ga = np.zeros(shape, np.int32)
    go = np.zeros(shape, np.int32)
    oi = np.zeros(shape, np.int32)
    oj = np.zeros(shape, np.int32)
    valid = np.zeros(shape, bool)
    for d in range(ndev):
        sel = owner == d
        k = int(sel.sum())
        li[d, :k] = anchor[sel] - d * nloc
        ga[d, :k] = anchor[sel]
        go[d, :k] = other[sel]
        oi[d, :k] = iu[sel]
        oj[d, :k] = ju[sel]
        valid[d, :k] = True
    return nloc, pmax, li, ga, go, oi, oj, valid


def _di_sharded_local(mesh: Mesh, mJ, C, q: int, *,
                      use_pallas: bool = False,
                      pair_chunk: int = 65536):
    """DI scores with mJ KEPT row-sharded (the storage-sharded path).

    ``_di_sharded`` gathers pair blocks from a replicated mJ — fine
    below ``solve_min_dim``, but it would re-replicate the (Ns)^2
    coupling matrix the distributed solve just kept sharded. Here each
    pair is assigned to a device that owns one endpoint's row block
    (``_pair_assignment``), so every gather is LOCAL: per-device memory
    stays O((Ns)^2 / ndev) through scoring.

    Anchor transposition: a pair anchored at j gathers J_ji = J_ij^T
    and swaps (L_i, L_j). DI is invariant under this: rho -> rho^T and
    spec(rho rho^T) = spec(rho^T rho), so logdet((I + sqrtm(I + 4
    rho rho^T))/2) is unchanged (values differ only by f32 rounding).

    The site Cholesky factors [N, s, s] are tiny and replicated.
    """
    from gaussdca_tpu.score.di import (_BM_MIN_PAIRS, _di_pairs_bm_minor,
                                       di_pairs_flat)
    from gaussdca_tpu.utils.chunked import balanced_chunk

    s = q - 1
    N = mJ.shape[0] // s
    ndev = mesh.devices.size
    dev_axes = (DATA_AXIS, MODEL_AXIS)
    nloc, pmax, li, ga, go, oi, oj, valid = _pair_assignment(N, ndev)
    Npd = nloc * ndev

    Lsite = site_cholesky(C, q)                          # [N, s, s] tiny

    bm = use_pallas and mJ.dtype == jnp.float32 and pmax >= _BM_MIN_PAIRS
    chunk = (pmax if pmax <= pair_chunk
             else balanced_chunk(pmax, pair_chunk, align=128))
    idx_specs = (P(dev_axes),) * 3

    if bm:
        # the coupling stays FLAT, row-sharded (an [N, s, N, s] view
        # need not fuse into its consumers and may materialize with the
        # small s-sized dim minor). Each pair's s x s block is one
        # slice of a vmapped
        # dynamic_slice (a single XLA gather with (s, s) slice sizes),
        # transposed to the batch-minor layout per chunk.
        J2 = mJ
        if Npd != N:
            J2 = jnp.pad(J2, ((0, (Npd - N) * s), (0, 0)))
        J2 = _constrain(J2, NamedSharding(mesh, P(dev_axes, None)))
        LsT = Lsite.transpose(1, 2, 0)                   # [s, s, N]

        def body(J2_loc, LsT_r, li_l, ga_l, go_l):
            outs = []
            for c0 in range(0, pmax, chunk):
                sl = slice(c0, c0 + chunk)
                blks = jax.vmap(
                    lambda r, c: jax.lax.dynamic_slice(
                        J2_loc, (r, c), (s, s)))(
                    li_l[sl] * s, go_l[sl] * s)          # [chunk, s, s]
                Jb = blks.transpose(1, 2, 0)             # [s, s, chunk]
                outs.append(_di_pairs_bm_minor(
                    Jb, LsT_r[:, :, ga_l[sl]], LsT_r[:, :, go_l[sl]]))
            return outs[0] if len(outs) == 1 else jnp.concatenate(outs)

        di = shard_map(
            body, mesh=mesh,
            in_specs=(P(dev_axes, None), P()) + idx_specs,
            out_specs=P(dev_axes), check_vma=False)(
                J2, LsT, jnp.asarray(li).reshape(-1),
                jnp.asarray(ga).reshape(-1), jnp.asarray(go).reshape(-1))
    else:
        J4 = mJ.reshape(N, s, N, s)
        if Npd != N:
            J4 = jnp.concatenate(
                [J4, jnp.zeros((Npd - N, s, N, s), J4.dtype)], axis=0)
        J4s = _constrain(
            J4, NamedSharding(mesh, P(dev_axes, None, None, None)))

        def body(J4_loc, Ls_r, li_l, ga_l, go_l):
            Jb = J4_loc[li_l, :, go_l, :]                # [pmax, s, s]
            return di_pairs_flat(Jb, Ls_r[ga_l], Ls_r[go_l],
                                 pair_chunk=pair_chunk,
                                 use_pallas=use_pallas)

        di = shard_map(
            body, mesh=mesh,
            in_specs=(P(dev_axes, None, None, None), P()) + idx_specs,
            out_specs=P(dev_axes), check_vma=False)(
                J4s, Lsite, jnp.asarray(li).reshape(-1),
                jnp.asarray(ga).reshape(-1), jnp.asarray(go).reshape(-1))

    di = jnp.where(jnp.asarray(valid).reshape(-1), di, 0.0)
    S = jnp.zeros((N, N), mJ.dtype)
    S = S.at[oi.reshape(-1), oj.reshape(-1)].add(di)
    return S + S.T


def _tile_assignment(N: int, ndev: int, tile_target: int = 128):
    """Static block-tile -> device assignment for the locally-TILED DI.

    Positions are padded so each device's row slab is ``nbl`` whole
    blocks of ``RB`` rows (``nbl = max(1, ceil(N/ndev) // tile_target)``,
    ``RB = ceil(ceil(N/ndev) / nbl)`` — RB stays in [tile_target,
    2*tile_target) once N >= ndev*tile_target, and padding is O(RB) per
    device). Upper-triangular tile (bi, bj) is anchored at block bi
    when (bi + bj) is even, else at bj: the anchor's owner computes the
    tile from a CONTIGUOUS slice of its local slab (an anchored-at-bj
    tile holds output block (bi, bj) transposed — free, by DI's anchor-
    transposition invariance). Each block anchors ~nb/2 tiles (half its
    row, half its column), so devices are balanced to O(nbl) tiles.

    Returns ``(RB, nb, tmax, r0_local, c0_global, slot_direct,
    slot_trans)``: per-device [ndev, tmax] offset arrays (padding slots
    use offset 0 — real data, never referenced by the slot maps) and
    the [nb, nb] assembly maps into the stacked [ndev*tmax (+1 zero),
    RB, RB] tile output (value ndev*tmax = the appended zero block).
    """
    nloc0 = -(-N // ndev)
    nbl = max(1, nloc0 // tile_target)
    RB = -(-nloc0 // nbl)
    nb = ndev * nbl
    bi, bj = np.triu_indices(nb)
    use_i = ((bi + bj) % 2) == 0
    anchor = np.where(use_i, bi, bj)
    other = np.where(use_i, bj, bi)
    owner = anchor // nbl
    tmax = int(np.bincount(owner, minlength=ndev).max())
    r0l = np.zeros((ndev, tmax), np.int32)
    c0g = np.zeros((ndev, tmax), np.int32)
    zero_slot = ndev * tmax
    slot_direct = np.full((nb, nb), zero_slot, np.int32)
    slot_trans = np.full((nb, nb), zero_slot, np.int32)
    fill = np.zeros(ndev, np.int64)
    for t in range(bi.size):
        d = owner[t]
        k = fill[d]
        fill[d] += 1
        r0l[d, k] = (anchor[t] - d * nbl) * RB
        c0g[d, k] = other[t] * RB
        (slot_direct if use_i[t] else slot_trans)[bi[t], bj[t]] = \
            d * tmax + k
    return RB, nb, tmax, r0l, c0g, slot_direct, slot_trans


def _di_sharded_tiled(mesh: Mesh, mJ, C, q: int, *,
                      pair_chunk: int = 65536,
                      tile_target: int = 128):
    """DI with mJ row-sharded AND zero gathers (opt-in,
    ``GDCA_DI_SHARDED=tiled``).

    ``_di_sharded_local`` keeps memory O((Ns)^2/ndev) but feeds the
    batch-minor core through per-lane fancy gathers
    (``J4T_loc[:, :, li, go]``) — the op class the single-chip dense-
    tile formulation was built to kill (profiled at N=1000: gathers +
    concat were ~2.4 s of a 3.0 s DI wall). Here each device instead
    enumerates dense RB x RB tiles anchored in its OWN row slab
    (``_tile_assignment``): every tile is a contiguous
    ``dynamic_slice`` of the device's flat [nloc*s, Npd*s] coupling
    slab (tile-local reshape/transpose to batch-minor layout),
    streamed through the same fixed-lane-buffer lax.map machinery as
    ``di_score_bm_mapped`` (uniform column strips, one compiled body).
    Assembly gathers whole RB x RB blocks (direct or transposed per the
    slot maps) — no per-lane indexing anywhere.

    Engages only when every tile carries a bm-scale lane batch
    (``ceil(N/ndev) >= tile_target``; callers gate and fall back to
    ``_di_sharded_local``). Flop overhead vs the gathered path:
    diagonal tiles compute their discarded i >= j lanes (~RB/N) plus
    O(RB) position padding — the same trade the single-card mapped
    formulation makes. Opt-in; not yet timed on the card.
    """
    from gaussdca_tpu.score.di import (_BM_MIN_PAIRS, _di_pairs_bm_minor,
                                       _finish_upper_blocks,
                                       _mapped_strip_plan,
                                       _strips_to_tiles)

    s = q - 1
    dtype = mJ.dtype
    N = mJ.shape[0] // s
    ndev = mesh.devices.size
    dev_axes = (DATA_AXIS, MODEL_AXIS)
    RB, nb, tmax, r0l, c0g, slot_d, slot_t = _tile_assignment(
        N, ndev, tile_target)
    nloc = (nb // ndev) * RB
    Npd = nb * RB

    Lsite = site_cholesky(C, q)
    # the coupling stays FLAT [Npd*s, Npd*s], row-sharded; tiles
    # reshape/transpose inside the body, so no full-size [s, s, Npd,
    # Npd] transposed copy crosses the shard_map/lax.map boundary
    J2 = mJ
    if Npd != N:
        pad = Npd - N
        # zero-padded sites: J blocks 0 -> G = I -> DI = 0 (finite)
        J2 = jnp.pad(J2, ((0, pad * s), (0, pad * s)))
        Lsite = jnp.pad(Lsite, ((0, pad), (0, 0), (0, 0)))
    J2 = _constrain(J2, NamedSharding(mesh, P(dev_axes, None)))
    LsT = Lsite.transpose(1, 2, 0)                   # [s, s, Npd] tiny

    lane_chunk = max(pair_chunk, _BM_MIN_PAIRS)
    nstrips, CB = _mapped_strip_plan(RB, lane_chunk)
    r0s = np.repeat(r0l, nstrips, axis=1)
    c0s = (np.repeat(c0g, nstrips, axis=1)
           + np.tile(np.tile(np.arange(nstrips, dtype=np.int32) * CB,
                             tmax), (ndev, 1)))
    row0 = np.arange(ndev, dtype=np.int32) * nloc    # global slab starts

    def body(J2_loc, LsT_r, r0_l, c0_l, row0_l):
        def one(offs):
            r0, c0 = offs
            z = jnp.zeros((), r0.dtype)
            blk = jax.lax.dynamic_slice(
                J2_loc, (r0 * s, c0 * s), (RB * s, CB * s))
            # same (i*CB + j) lane order as the J4T-slice form
            Jb = (blk.reshape(RB, s, CB, s).transpose(1, 3, 0, 2)
                  .reshape(s, s, RB * CB))
            Li = jnp.broadcast_to(
                jax.lax.dynamic_slice(
                    LsT_r, (z, z, row0_l[0] + r0),
                    (s, s, RB))[..., None],
                (s, s, RB, CB)).reshape(s, s, RB * CB)
            Lj = jnp.broadcast_to(
                jax.lax.dynamic_slice(
                    LsT_r, (z, z, c0), (s, s, CB))[:, :, None],
                (s, s, RB, CB)).reshape(s, s, RB * CB)
            return _di_pairs_bm_minor(Jb, Li, Lj).reshape(RB, CB)

        strips = jax.lax.map(one, (r0_l, c0_l))   # [tmax*nstrips, RB, CB]
        return _strips_to_tiles(strips, tmax, nstrips, RB, CB)

    tiles = shard_map(
        body, mesh=mesh,
        in_specs=(P(dev_axes, None), P(),
                  P(dev_axes), P(dev_axes), P(dev_axes)),
        out_specs=P(dev_axes, None, None), check_vma=False)(
            J2, LsT, jnp.asarray(r0s).reshape(-1),
            jnp.asarray(c0s).reshape(-1), jnp.asarray(row0))

    tiles = jnp.concatenate(
        [tiles, jnp.zeros((1, RB, RB), dtype)], axis=0)
    U = (tiles[jnp.asarray(slot_d)]
         + tiles[jnp.asarray(slot_t)].swapaxes(-1, -2))
    U = U.transpose(0, 2, 1, 3).reshape(Npd, Npd)
    # the shared NaN-safe diagonal mask + symmetrize (score/di.py)
    return _finish_upper_blocks(U, RB, N)


def _di_sharded_tiled_ok(N: int, ndev: int, dtype, use_pallas,
                         tile_target: int = 128) -> bool:
    """Gate for the opt-in locally-tiled DI: the env knob is set AND
    every tile carries a bm-scale lane batch AND the bm core's own
    conditions hold (f32, kernel path)."""
    import os

    if os.environ.get("GDCA_DI_SHARDED", "").lower() != "tiled":
        return False
    if not (use_pallas and jnp.dtype(dtype) == jnp.float32):
        return False
    return -(-N // ndev) >= tile_target


def sharded_scores_fn(mesh: Mesh, *, q: int, score: str,
                      theta_is_auto: bool, dtype,
                      solve_min_dim: int = 4096, solve_block: int = 1024,
                      use_pallas: bool = None, freq_chunk: int = 0,
                      precision: str = "highest"):
    """Build the jitted sharded pipeline for a fixed mesh/config.

    Returns ``fn(Z, pc, theta_value, m_true, n_true) -> (S, theta, Meff)``.
    Z must be padded to a multiple of the device count (``run_sharded``
    and the api dispatch do this); ``m_true`` / ``n_true`` are TRACED
    unpadded sequence / position counts (pass M / N when nothing is
    padded — token-0 padding rows are masked out of weights, Meff, and
    the auto-theta pair count; padding columns decouple exactly, see
    stats/pseudocount.py). ``solve_min_dim``: N*s at or above which the
    covariance inverse uses the mesh-blocked distributed solve instead of
    the replicated one.
    """
    if use_pallas is None:
        from gaussdca_tpu.ops import dispatch
        form = dispatch.formulation()
        fast_rows, di_bm = form.streaming_row_stats, form.di_batch_minor
    else:
        fast_rows = di_bm = bool(use_pallas)

    dev_axes = (DATA_AXIS, MODEL_AXIS)
    rows_all = NamedSharding(mesh, P(dev_axes, None))
    model2 = NamedSharding(mesh, P(MODEL_AXIS, None))
    repl = NamedSharding(mesh, P())

    row_stats = shard_map(
        _row_stats_local(q, fast_rows), mesh=mesh,
        in_specs=(P(dev_axes, None), P(), P()),
        out_specs=(P(dev_axes), P(dev_axes)), check_vma=False)

    def fn(Z, pc, theta_value, m_true, n_true):
        with jax.default_matmul_precision(precision):
            return _fn_body(Z, pc, theta_value, m_true, n_true)

    def _fn_body(Z, pc, theta_value, m_true, n_true):
        M, N = Z.shape

        # --- reweighting: DP rows vs replicated tokens, O(M) memory ----
        # same streaming semantics as the single-chip path, with the
        # shard_map'd rectangular row-stats kernel injected
        theta = "auto" if theta_is_auto else theta_value
        W, Meff, th = reweight.compute_weights_streaming(
            Z, theta, q, lambda z, t, _q: row_stats(z, z, t),
            dtype=dtype, m_true=m_true, n_true=n_true)

        # --- weighted frequencies: per-device partials + one psum -------
        freqs = shard_map(
            _freq_partial(q, dtype, freq_chunk), mesh=mesh,
            in_specs=(P(dev_axes, None), P(dev_axes)),
            out_specs=(P(), P()), check_vma=False)
        Pi, Pij = freqs(Z, W)
        Pi = Pi / Meff
        Pij = _constrain(Pij / Meff, model2)

        # --- pseudocount + covariance: model-sharded elementwise ---------
        Pi, Pij = add_pseudocount(Pi, Pij, pc, q, n_true=n_true)
        C = _constrain(compute_C(Pi, Pij, n_true=n_true, q=q), model2)

        # --- solve: replicated below the threshold, storage-sharded
        # above (C, L, W, and mJ all stay row-sharded; per-device memory
        # O((Ns)^2/ndev) — see solve/distributed.py) -----------------
        Ns = C.shape[0]
        storage_sharded = Ns >= solve_min_dim
        if storage_sharded:
            rows2 = NamedSharding(mesh, P(dev_axes, None))
            Cuse = _constrain(C, rows2)
            mJ = spd_inverse_dist(Cuse, mesh=mesh,
                                  block=min(solve_block, Ns))
        else:
            Cuse = _constrain(C, repl)
            mJ = spd_inverse(Cuse)

        # --- scores: DI pairs / frob rows sharded over the mesh ----------
        s = q - 1
        if score == "DI":
            if storage_sharded:
                if _di_sharded_tiled_ok(N, mesh.devices.size, dtype,
                                        di_bm):
                    # opt-in zero-gather variant (GDCA_DI_SHARDED=tiled,
                    # read at TRACE time like the other kernel knobs)
                    S = _di_sharded_tiled(mesh, mJ, Cuse, q)
                else:
                    # local-gather DI: mJ row-sharded and stays that way
                    S = _di_sharded_local(mesh, mJ, Cuse, q,
                                          use_pallas=di_bm)
            else:
                S = _di_sharded(mesh, mJ, Cuse, q, use_pallas=di_bm)
        else:
            J4 = _constrain(
                mJ.reshape(N, s, N, s),
                NamedSharding(mesh, P(dev_axes, None, None, None)))
            S = jax.vmap(lambda row: _fn_row(row, q))(J4)
            S = S * (1.0 - jnp.eye(N, dtype=dtype))
        S = correct_apc(S, n_true=n_true)
        return _constrain(S, repl), th, Meff

    return jax.jit(
        fn,
        in_shardings=(rows_all, repl, repl, repl, repl),
        out_shardings=(repl, repl, repl),
    )


@functools.lru_cache(maxsize=64)
def cached_scores_fn(mesh: Mesh, *, q: int, score: str,
                     theta_is_auto: bool, dtype_name: str,
                     solve_min_dim: int = 4096, solve_block: int = 1024,
                     use_pallas: bool = None, freq_chunk: int = 0,
                     precision: str = "highest"):
    """``sharded_scores_fn`` memoized on (mesh, config).

    Each ``sharded_scores_fn`` call builds a fresh closure, which jit
    treats as a distinct function — without this cache every family in a
    batch would recompile. Mesh objects hash by device grid + axis names,
    so equal meshes share entries.
    """
    return sharded_scores_fn(
        mesh, q=q, score=score, theta_is_auto=theta_is_auto,
        dtype=jnp.dtype(dtype_name), solve_min_dim=solve_min_dim,
        solve_block=solve_block, use_pallas=use_pallas,
        freq_chunk=freq_chunk, precision=precision)


def run_sharded(mesh: Mesh, Z, pc: float, theta: Union[str, float], *,
                q: int, score: str = "frob", dtype=jnp.float32,
                solve_min_dim: int = 4096, solve_block: int = 1024,
                use_pallas: bool = None, freq_chunk: int = 0,
                precision: str = "highest"):
    """Convenience wrapper: pad/place Z on the mesh and run one step.

    Works on pod-spanning meshes too (every process calls this with the
    same host Z; see api.put_global)."""
    from gaussdca_tpu.api import put_global

    theta_is_auto = isinstance(theta, str)
    Z = np.asarray(Z)
    M, N = Z.shape
    ndev = mesh.devices.size
    Mp = -(-M // ndev) * ndev
    fn = cached_scores_fn(mesh, q=q, score=score,
                          theta_is_auto=theta_is_auto,
                          dtype_name=jnp.dtype(dtype).name,
                          solve_min_dim=solve_min_dim,
                          solve_block=solve_block,
                          use_pallas=use_pallas,
                          freq_chunk=freq_chunk,
                          precision=precision)
    if Mp != M:
        Z = np.concatenate(
            [Z, np.zeros((Mp - M, Z.shape[1]), Z.dtype)], axis=0)
    Zs = put_global(
        Z, NamedSharding(mesh, P((DATA_AXIS, MODEL_AXIS), None)))
    repl = NamedSharding(mesh, P())
    np_dt = jnp.dtype(dtype)
    pc_a = put_global(np.asarray(pc, np_dt), repl)
    th_a = put_global(
        np.asarray(0.0 if theta_is_auto else float(theta), np_dt), repl)
    return fn(Zs, pc_a, th_a,
              put_global(np.asarray(M, np.int32), repl),
              put_global(np.asarray(N, np.int32), repl))
