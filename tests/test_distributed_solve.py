"""Storage-sharded solve + local-gather DI (solve/distributed.py).

The reference's L5 is a replicated one-liner
(/root/reference/src/GaussDCA.jl:34); the storage-sharded path must (a)
agree with the replicated solver to factorization round-off, and (b)
actually hold only 1/ndev of each matrix per device. (b) is asserted
STRUCTURALLY on the SPMD-partitioned HLO: the per-device program of the
distributed solve contains no full-size [n, n] tensor at all, while the
replicated-compute blocked path materializes many.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussdca_tpu.parallel import mesh as meshlib
from gaussdca_tpu.solve.cholesky import spd_inverse
from gaussdca_tpu.solve.distributed import plan_padding, spd_inverse_dist


def _spd(n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, max(n // 4, 16)))
    C = A @ A.T / A.shape[1] + 0.5 * np.eye(n)
    return jnp.asarray(C.astype(dtype))


def test_plan_padding_geometry():
    for n in (100, 1060, 8000, 20000, 7260):
        for ndev in (1, 2, 8):
            for block in (64, 512, 1024):
                npad, w, b = plan_padding(n, ndev, block)
                assert npad >= n and npad == ndev * w
                assert w % b == 0 and b <= block
                # bounded padding overhead
                assert npad - n < ndev * b


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
@pytest.mark.parametrize("n,block", [(100, 16), (700, 64), (300, 512)])
def test_spd_inverse_dist_matches_dense_f64(n, block):
    # three geometry classes, one compile each (each leg costs ~2-3 min
    # of CPU-XLA compile for the unrolled 8-device program): small n
    # with padding (100 % 16 != 0), multi-panel (700/64), and the
    # block > per-device-width clamp (300/512). A fourth small
    # divisible leg (96/32) added no geometry the first doesn't cover.
    C = _spd(n, seed=11 * n)
    m = meshlib.make_mesh(8, shape=(4, 2))
    got = np.asarray(spd_inverse_dist(C, mesh=m, block=block))
    want = np.linalg.inv(np.asarray(C))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-11, err
    np.testing.assert_allclose(got, got.T)  # exactly symmetrized


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_spd_inverse_dist_f32_newton():
    n = 350          # mixed-precision accuracy is n-insensitive here;
    C = _spd(n, seed=5, dtype=np.float32)   # half the unrolled compile
    m = meshlib.make_mesh(8, shape=(4, 2))
    got = np.asarray(spd_inverse_dist(C, mesh=m, block=64))
    want = np.linalg.inv(np.asarray(C, np.float64))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 5e-5, err


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_storage_sharded_no_full_size_tensor():
    """Memory property, asserted on the partitioned per-device HLO:
    the distributed solve's program has NO [n, n]-sized tensor (its
    largest live buffers are the [n/ndev, n] slabs and the [n, b]
    gathered column block), while the replicated-compute blocked path
    materializes full-size L / identity / inverse buffers."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gaussdca_tpu.solve.blocked import spd_inverse_blocked

    n = 4096
    m = meshlib.make_mesh(8, shape=(4, 2))
    spec = NamedSharding(m, P(("data", "model"), None))
    sd = jax.ShapeDtypeStruct((n, n), jnp.float32)

    def shapes_of(fn):
        comp = jax.jit(fn, in_shardings=spec,
                       out_shardings=spec).lower(sd).compile()
        return re.findall(r"f32\[(\d+),(\d+)\]", comp.as_text())

    full = {(str(n), str(n))}
    dist_shapes = set(shapes_of(
        lambda C: spd_inverse_dist(C, mesh=m, block=512)))
    assert not (dist_shapes & full), sorted(dist_shapes & full)
    # the largest 2-D tensor is per-device-slab-sized or the [n, b] panel
    max_elems = max(int(a) * int(b) for a, b in dist_shapes)
    assert max_elems <= (n // 8) * n, max_elems

    blocked_shapes = set(shapes_of(
        lambda C: spd_inverse_blocked(C, block=512, mesh=m)))
    assert blocked_shapes & full  # the replicated path does materialize


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_storage_sharded_memory_at_32768():
    """The same per-device memory property at the scale the design
    claim is about (Ns = 32768: a 4 GiB f32 covariance). Compile-only:
    the partitioned per-device HLO must hold no tensor larger than the
    [n/ndev, n] row slab (512 MiB/device)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = 32768
    m = meshlib.make_mesh(8, shape=(4, 2))
    spec = NamedSharding(m, P(("data", "model"), None))
    sd = jax.ShapeDtypeStruct((n, n), jnp.float32)
    comp = jax.jit(lambda C: spd_inverse_dist(C, mesh=m, block=2048),
                   in_shardings=spec,
                   out_shardings=spec).lower(sd).compile()
    shapes = re.findall(r"f32\[(\d+),(\d+)\]", comp.as_text())
    assert shapes, "no 2-D f32 tensors found in the per-device HLO?"
    assert (str(n), str(n)) not in set(shapes)
    max_elems = max(int(a) * int(b) for a, b in shapes)
    assert max_elems <= (n // 8) * n, max_elems


def test_pair_assignment_properties():
    from gaussdca_tpu.parallel.sharded import _pair_assignment

    for N, ndev in ((53, 8), (128, 8), (400, 4), (9, 2)):
        nloc, pmax, li, ga, go, oi, oj, valid = _pair_assignment(N, ndev)
        P_ = N * (N - 1) // 2
        assert valid.sum() == P_
        assert pmax % 128 == 0
        # balance: the busiest device holds at most ~P/ndev plus an
        # O(nloc^2) partial-block term (the last site block can be
        # nearly empty when ndev does not divide N)
        counts = valid.sum(axis=1)
        assert counts.max() <= -(-P_ // ndev) + nloc * nloc
        # every pair covered exactly once, anchors owned locally
        pairs = {(int(a), int(b))
                 for a, b in zip(oi[valid], oj[valid])}
        assert pairs == {(i, j) for i in range(N)
                         for j in range(i + 1, N)}
        for d in range(ndev):
            v = valid[d]
            assert (ga[d][v] // nloc == d).all()
            assert (li[d][v] == ga[d][v] - d * nloc).all()
            anc = set(zip(ga[d][v].tolist(), go[d][v].tolist()))
            assert {tuple(sorted(p)) for p in anc} == \
                {(int(a), int(b)) for a, b in zip(oi[d][v], oj[d][v])}


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_di_local_gather_matches_replicated_f64():
    """The local-gather DI (row-sharded mJ, anchor transposition) equals
    the replicated-gather mesh DI in f64."""
    from gaussdca_tpu.parallel.sharded import _di_sharded, _di_sharded_local
    from gaussdca_tpu.score.di import di_score

    q, N = 6, 40
    s = q - 1
    Ns = N * s
    rng = np.random.default_rng(3)
    A = rng.standard_normal((Ns, Ns))
    C = jnp.asarray(A @ A.T / Ns + 0.8 * np.eye(Ns))
    mJ = spd_inverse(C)
    m = meshlib.make_mesh(8, shape=(4, 2))
    S_rep = np.asarray(jax.jit(
        lambda a, b: _di_sharded(m, a, b, q, use_pallas=False))(mJ, C))
    S_loc = np.asarray(jax.jit(
        lambda a, b: _di_sharded_local(m, a, b, q,
                                       use_pallas=False))(mJ, C))
    S_one = np.asarray(di_score(mJ, C, q, use_pallas=False))
    np.testing.assert_allclose(S_loc, S_rep, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(S_loc, S_one, rtol=1e-9, atol=1e-12)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_di_local_gather_bm_core_f32():
    """The batch-minor local-gather branch (f32, per-device slab above
    _BM_MIN_PAIRS) agrees with the replicated f32 gemm path."""
    from gaussdca_tpu.parallel.sharded import _di_sharded_local
    from gaussdca_tpu.score.di import _BM_MIN_PAIRS, di_score

    q, N = 5, 520                      # pmax ~ P/8 ~ 16.9k > 16384
    s = q - 1
    Ns = N * s
    rng = np.random.default_rng(7)
    A = rng.standard_normal((Ns, Ns)).astype(np.float32)
    C = jnp.asarray(A @ A.T / Ns + 0.8 * np.eye(Ns, dtype=np.float32))
    mJ = spd_inverse(C.astype(jnp.float64)).astype(jnp.float32)
    m = meshlib.make_mesh(8, shape=(4, 2))
    from gaussdca_tpu.parallel.sharded import _pair_assignment
    _, pmax, *_ = _pair_assignment(N, 8)
    assert pmax >= _BM_MIN_PAIRS  # the bm branch actually engages
    S_bm = np.asarray(jax.jit(
        lambda a, b: _di_sharded_local(m, a, b, q,
                                       use_pallas=True))(mJ, C))
    S_ref = np.asarray(di_score(mJ, C, q, use_pallas=False))
    err = np.abs(S_bm - S_ref).max() / np.abs(S_ref).max()
    assert err < 5e-4, err


def test_tile_assignment_properties():
    """Block-parity tile assignment (locally-tiled DI): every upper-
    triangular block covered exactly once across the direct/transposed
    slot maps, offsets stay inside the owner's slab, devices balanced
    to O(blocks-per-device)."""
    from gaussdca_tpu.parallel.sharded import _tile_assignment

    for N, ndev, tt in ((1000, 8, 128), (2500, 8, 128), (1024, 8, 128),
                        (120, 8, 8), (53, 4, 4), (313 * 8, 8, 128)):
        RB, nb, tmax, r0l, c0g, sd, st = _tile_assignment(N, ndev, tt)
        nbl = nb // ndev
        assert nb * RB >= N
        assert nb % ndev == 0
        if -(-N // ndev) >= tt:           # the gate's regime
            assert tt <= RB < 2 * tt
        zero = ndev * tmax
        bi, bj = np.triu_indices(nb)
        used = set()
        for a, b in zip(bi, bj):
            d_slot, t_slot = int(sd[a, b]), int(st[a, b])
            # exactly one of the two maps holds the block
            assert (d_slot == zero) != (t_slot == zero), (a, b)
            slot = d_slot if d_slot != zero else t_slot
            assert slot not in used      # one tile per block
            used.add(slot)
            # the computing device owns the anchor's rows
            anchor = a if d_slot != zero else b
            d, k = divmod(slot, tmax)
            assert anchor // nbl == d
            assert int(r0l[d, k]) == (anchor - d * nbl) * RB
            assert int(c0g[d, k]) == (b if d_slot != zero else a) * RB
        # lower triangle: zero block in both maps
        tril = np.tril_indices(nb, k=-1)
        assert (sd[tril] == zero).all() and (st[tril] == zero).all()
        # balance: each block anchors ~nb/2 tiles
        T = nb * (nb + 1) // 2
        assert tmax <= T // ndev + nbl + 2, (N, ndev, tmax)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_di_sharded_tiled_matches_local():
    """The zero-gather locally-tiled DI must match the local-gather bm
    path to f32 rounding (same per-lane math, different batching) and
    stay inside the f32 envelope vs the f64 reference — including a
    production-gate-shaped config (nloc = tile_target = 128) and a
    small config with padding + transposed-anchor assembly."""
    from gaussdca_tpu.parallel.sharded import (_di_sharded_local,
                                               _di_sharded_tiled)
    from gaussdca_tpu.score.di import di_score

    m = meshlib.make_mesh(8, shape=(4, 2))
    for q, N, tt in ((3, 120, 8), (3, 1024, 128)):
        s = q - 1
        Ns = N * s
        rng = np.random.default_rng(13)
        A = rng.standard_normal((Ns, Ns)).astype(np.float32) * 0.1
        C = jnp.asarray(A @ A.T / Ns + np.eye(Ns, dtype=np.float32))
        mJ = spd_inverse(C.astype(jnp.float64)).astype(jnp.float32)

        S_t = np.asarray(jax.jit(
            lambda a, b: _di_sharded_tiled(m, a, b, q,
                                           tile_target=tt))(mJ, C))
        S_l = np.asarray(jax.jit(
            lambda a, b: _di_sharded_local(m, a, b, q,
                                           use_pallas=True))(mJ, C))
        np.testing.assert_allclose(S_t, S_l, rtol=1e-5, atol=1e-6,
                                   err_msg=f"q={q} N={N}")
        assert np.array_equal(S_t, S_t.T)
        assert np.all(np.diag(S_t) == 0.0)

        S_ref = np.asarray(
            di_score(mJ.astype(jnp.float64), C.astype(jnp.float64), q,
                     use_pallas=False))
        err = np.abs(S_t - S_ref).max()
        assert err < 2e-5, (q, N, err)


def test_di_sharded_tiled_gate(monkeypatch):
    """GDCA_DI_SHARDED=tiled engages only where every tile carries a
    bm-scale lane batch (nloc >= tile_target) on the f32 kernel path."""
    from gaussdca_tpu.parallel.sharded import _di_sharded_tiled_ok

    monkeypatch.delenv("GDCA_DI_SHARDED", raising=False)
    assert not _di_sharded_tiled_ok(4096, 8, jnp.float32, True)
    monkeypatch.setenv("GDCA_DI_SHARDED", "tiled")
    assert _di_sharded_tiled_ok(1024, 8, jnp.float32, True)
    assert _di_sharded_tiled_ok(4096, 8, jnp.float32, True)
    assert not _di_sharded_tiled_ok(1016, 8, jnp.float32, True)
    assert not _di_sharded_tiled_ok(4096, 8, jnp.float64, True)
    assert not _di_sharded_tiled_ok(4096, 8, jnp.float32, False)


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 devices")
def test_di_sharded_bodies_no_full_coupling_tensor():
    """Memory property of the storage-sharded DI bodies, asserted on
    the partitioned per-device HLO (compile-only): neither the
    local-gather nor the locally-tiled body materializes the full
    [s, s, Npd, Npd] transposed coupling view — the largest 4-D tensor
    stays at the per-device slab s^2*Npd^2/ndev (q=6 so the slab bound
    dominates the [nb, nb, RB, RB] position-space assembly, which is
    s^2 times smaller than the coupling view)."""
    import re
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gaussdca_tpu.parallel.sharded import (_di_sharded_local,
                                               _di_sharded_tiled)

    q, N = 6, 1024
    s = q - 1
    Ns = N * s
    ndev = 8
    m = meshlib.make_mesh(ndev, shape=(4, 2))
    spec = NamedSharding(m, P(("data", "model"), None))
    sd = jax.ShapeDtypeStruct((Ns, Ns), jnp.float32)

    for name, fn in (
            ("tiled", lambda a, b: _di_sharded_tiled(m, a, b, q)),
            ("local", lambda a, b: _di_sharded_local(m, a, b, q,
                                                     use_pallas=True))):
        comp = jax.jit(fn, in_shardings=(spec, spec)).lower(
            sd, sd).compile()
        shapes4 = re.findall(r"f32\[(\d+),(\d+),(\d+),(\d+)\]",
                             comp.as_text())
        assert shapes4, f"{name}: no 4-D f32 tensors in the HLO?"
        elems = [int(a) * int(b) * int(c) * int(d)
                 for a, b, c, d in shapes4]
        full = s * s * N * N
        assert max(elems) < full, \
            f"{name}: full coupling view materialized per device " \
            f"({max(elems)} >= {full})"
        assert max(elems) <= full // ndev, (name, max(elems))
