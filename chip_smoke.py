"""Start-up check of the gDCA pipeline on NVIDIA cards.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the mesh path only

One card, one process. Phases, each printed with its wall time, the
device's ``peak_bytes_in_use`` and PASS/FAIL:

- golden: the four reference configs through ``gaussdca_tpu.gdca`` in
  f32 under the shipped defaults against ``tests/data`` — identical pair
  sets, 100% top-10 and top-100 overlap, max abs error <= 5e-4 (small)
  and <= 1e-3 (large);
- row-stats: the platform's row statistics at M=32768, N=384, q=21,
  square and rectangular, against the broadcast-compare reference on
  the card — integer counts, so exactly equal;
- deep: the CLI in-process on a gzipped FASTA of M=100,000 x N=200
  (q=21, auto-theta, frob) made from a fixed seed; its rank file must
  hold every pair, finite and sorted;
- wide: the CLI in-process on M=4096 x N=1000, DI, pseudocount 0.2 (the
  split pipeline and the Ns=20,000 solve), against the same family run
  in f64 on the card: 100% top-100 overlap and max abs error <= 1e-3 on
  the f64 top-100 pairs (the large golden config's gate);
- card tests: the ``gpu``-marked tests of ``tests/``, which need a card.

``--four-cards`` runs ``gdca(..., mesh=(2, 2))`` and ``mesh=(1, 4)`` on
the large golden family (frob and DI) against the single-card scores of
the same process, and the wide family with the storage-sharded solve,
and prints every device's peak memory. The mesh solves Ns=8000 with the
storage-sharded factorization, a different f32 algorithm from the
single card's doubling inverse, so each side may sit up to the golden
tolerance 1e-3 from the reference and the two are compared at twice it:
100% top-10/top-100 overlap and max abs difference <= 2e-3.

Exits non-zero, without the final line, when JAX finds no GPU or any
phase fails. The last line of a passing run is one JSON object naming
the device.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data")
# scratch space inside the checkout (listed in .gitignore)
WORK = os.path.join(REPO, ".work")

GOLDEN_CASES = [
    ("small frob defaults", "small.fasta.gz", "small.FNRout.txt",
     dict(), 5e-4),
    ("small DI dedup", "small.fasta.gz", "small.DIRout.txt",
     dict(score="DI", pseudocount=0.2, remove_dups=True), 5e-4),
    ("small DI theta0", "small.fasta.gz", "small.DIRout2.txt",
     dict(score="DI", pseudocount=0.2, theta=0.0, max_gap_fraction=0.8,
          min_separation=4), 5e-4),
    ("large DI dedup", "large.fasta.gz", "large.DIRout.txt",
     dict(score="DI", pseudocount=0.2, remove_dups=True), 1e-3),
]
_LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY-", dtype=np.uint8)
# (M, N) of the row-stats, deep and wide phases
ROW_STATS_SHAPE = (32768, 384)
DEEP_SHAPE = (100_000, 200)
WIDE_SHAPE = (4096, 1000)


def _peak(device=None) -> int:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def _phase(name, fn, failures):
    t0 = time.perf_counter()
    ok = bool(fn())
    print(f"phase {name}: wall {time.perf_counter() - t0:.2f} s, "
          f"peak_bytes_in_use {_peak()}, {'PASS' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        failures.append(name)


def _load_rank(path):
    out = {}
    with open(path) as fh:
        for line in fh:
            t = line.split()
            out[(int(t[0]), int(t[1]))] = float(t[2])
    return out


def _compare(got, want, tol, label, err_keys=None):
    """Golden-style gate: same pairs, 100% top-10/top-100, max abs err
    over ``err_keys`` (default: every pair)."""
    same = set(got) == set(want)
    if not same:
        print(f"  [{label}] pair sets differ -> FAIL", flush=True)
        return False
    keys = sorted(want) if err_keys is None else err_keys
    err = float(np.max(np.abs(np.array([got[k] for k in keys])
                              - np.array([want[k] for k in keys]))))
    order_w = sorted(want, key=lambda k: -want[k])
    order_g = sorted(got, key=lambda k: -got[k])
    overlap = {K: len(set(order_w[:K]) & set(order_g[:K]))
               for K in (10, 100)}
    ok = err <= tol and overlap == {10: 10, 100: 100}
    print(f"  [{label}] max abs err {err:.2e} (tol {tol:.0e}); "
          f"top-K overlap {overlap} -> {'PASS' if ok else 'FAIL'}",
          flush=True)
    return ok


def synth_family(M, N, q=21, *, n_founders=64, mutate=0.3, n_pairs=0,
                 seed=0):
    """[M, N] tokens in 1..q: ``n_founders`` founder sequences, each
    descendant resampling a ``mutate`` share of its founder's positions
    (redundancy that the reweighting collapses), and ``n_pairs`` planted
    covarying position pairs (column j a permuted image of column i)."""
    rng = np.random.default_rng(seed)
    founders = rng.integers(1, q + 1, size=(n_founders, N), dtype=np.int8)
    Z = founders[rng.integers(0, n_founders, size=M)]
    mut = rng.random((M, N)) < mutate
    Z[mut] = rng.integers(1, q + 1, size=int(mut.sum()), dtype=np.int8)
    cols = rng.permutation(N)[:2 * n_pairs].reshape(-1, 2)
    for i, j in cols:
        copy = rng.random(M) < rng.uniform(0.5, 0.95)
        perm = (rng.permutation(q) + 1).astype(np.int8)
        Z[copy, j] = perm[Z[copy, i] - 1]
    return Z


def write_fasta_gz(path, Z):
    M, N = Z.shape
    body = np.empty((M, N + 1), np.uint8)
    body[:, :N] = _LETTERS[Z - 1]
    body[:, N] = ord("\n")
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for k in range(0, M, 8192):
            rows = body[k:k + 8192]
            fh.write(b"".join(b">s%d\n" % (k + r) + rows[r].tobytes()
                              for r in range(len(rows))))


def run_cli(args):
    from gaussdca_tpu import cli

    rc = cli.main(args + ["--quiet"])
    if rc != 0:
        print(f"  cli exited {rc}", flush=True)
    return rc == 0


def phase_golden():
    import gaussdca_tpu as g

    ok = True
    for name, fa, gold, kw, tol in GOLDEN_CASES:
        r = g.gdca(os.path.join(GOLDEN, fa), **kw)
        got = {(i, j): s for i, j, s in r.ranking}
        ok &= _compare(got, _load_rank(os.path.join(GOLDEN, gold)), tol,
                       name)
    return ok


def phase_row_stats():
    import jax
    import jax.numpy as jnp
    from gaussdca_tpu.ops import dispatch, distance

    (M, N), q = ROW_STATS_SHAPE, 21
    rect = M // 4
    rng = np.random.default_rng(0)
    Z = jnp.asarray(rng.integers(0, q + 1, size=(M, N), dtype=np.int8))
    th = jnp.float32(int(0.2 * N))
    row_stats = dispatch.kernels()["row_stats_fn"]
    ref = [np.asarray(x) for x in jax.jit(
        lambda z: distance.row_stats_rect_jnp(z, z, th, q))(Z)]
    ok = True
    for label, fn, rows in (
            ("square", jax.jit(lambda z: row_stats(z, th, q)), M),
            (f"rect {rect} x {M}",
             jax.jit(lambda z: distance.row_stats_xla(z[:rect], z, th, q)),
             rect)):
        got = [np.asarray(x) for x in fn(Z)]
        exact = all(np.array_equal(a, b[:rows]) for a, b in zip(got, ref))
        jax.block_until_ready(fn(Z))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(Z))
        dt = time.perf_counter() - t0
        print(f"  [{label}] exact {exact}; {dt * 1e3:.2f} ms", flush=True)
        ok &= exact
    return ok


def phase_deep():
    M, N = DEEP_SHAPE
    path = os.path.join(WORK, "deep.fasta.gz")
    write_fasta_gz(path, synth_family(M, N, n_founders=2000, mutate=0.25,
                                      n_pairs=20, seed=1))
    out = os.path.join(WORK, "deep_out")
    if not run_cli([path, "-o", out, "--score", "frob"]):
        return False
    rank = _load_rank(os.path.join(out, "deep.rank.txt"))
    vals = np.array(list(rank.values()))
    want = (N - 5) * (N - 4) // 2          # pairs with j - i >= 5
    ok = (len(rank) == want and bool(np.isfinite(vals).all())
          and bool(np.all(np.diff(vals) <= 0)))
    print(f"  [deep M={M} N={N}] {len(rank)} pairs (want {want}), "
          f"finite and sorted {ok}", flush=True)
    return ok


def phase_wide():
    import jax

    M, N = WIDE_SHAPE
    path = os.path.join(WORK, "wide.fasta.gz")
    write_fasta_gz(path, synth_family(M, N, n_founders=256, mutate=0.3,
                                      n_pairs=150, seed=2))
    common = [path, "--score", "DI", "--pseudocount", "0.2"]
    if not run_cli(common + ["-o", os.path.join(WORK, "wide32")]):
        return False
    try:
        if not run_cli(common + ["-o", os.path.join(WORK, "wide64"),
                                 "--dtype", "float64"]):
            return False
    finally:
        jax.config.update("jax_enable_x64", False)
    got = _load_rank(os.path.join(WORK, "wide32", "wide.rank.txt"))
    want = _load_rank(os.path.join(WORK, "wide64", "wide.rank.txt"))
    top = sorted(want, key=lambda k: -want[k])[:100]
    return _compare(got, want, 1e-3, f"wide M={M} N={N} DI f32 vs f64",
                    err_keys=top)


def phase_card_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")],
                     plugins=[Count()])
    print(f"  [card tests] pytest exit {int(rc)}, {Count.passed} passed",
          flush=True)
    return int(rc) == 0 and Count.passed > 0


def phase_mesh():
    import jax
    import gaussdca_tpu as g
    from gaussdca_tpu import api
    from gaussdca_tpu.core.config import GDCAConfig
    from gaussdca_tpu.io.fasta import MSA

    ok = True
    path = os.path.join(GOLDEN, "large.fasta.gz")
    for score, kw in (("frob", {}),
                      ("DI", dict(pseudocount=0.2, remove_dups=True))):
        one = {(i, j): s for i, j, s in g.gdca(path, score=score, **kw)}
        for shape in ((2, 2), (1, 4)):
            r = g.gdca(path, score=score, mesh=shape, **kw)
            ok &= _compare({(i, j): s for i, j, s in r}, one, 2e-3,
                           f"large {score} mesh {shape} vs one card")
    M, N = WIDE_SHAPE
    Z = synth_family(M, N, n_founders=256, mutate=0.3, n_pairs=150, seed=2)
    msa = MSA(tokens=Z.astype(np.uint8),
              headers=[f"s{k}" for k in range(M)], q=21)
    cfg = dict(score="DI", pseudocount=0.2, dtype="float32")
    one = {(i, j): s for i, j, s in api.gdca_from_msa(msa, GDCAConfig(**cfg))}
    r = api.gdca_from_msa(msa, GDCAConfig(**cfg, solve_min_dim=4096,
                                          solve_block=1024), mesh=(2, 2))
    ok &= _compare({(i, j): s for i, j, s in r}, one, 2e-3,
                   f"wide M={M} N={N} DI storage-sharded mesh (2, 2)",
                   err_keys=sorted(one, key=lambda k: -one[k])[:100])
    for d in jax.devices():
        print(f"  device {d.id}: peak_bytes_in_use {_peak(d)}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    want = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)  # one "name, power limit" line per card

    sys.path.insert(0, REPO)
    from gaussdca_tpu.cli import setup_compile_cache
    from gaussdca_tpu.io import native

    setup_compile_cache()
    print(f"native ingest: {native.backend() or 'unavailable (NumPy parser)'}",
          flush=True)
    os.makedirs(WORK, exist_ok=True)
    failures = []
    if args.four_cards:
        _phase("mesh", phase_mesh, failures)
    else:
        _phase("golden", phase_golden, failures)
        _phase("row-stats", phase_row_stats, failures)
        _phase("deep", phase_deep, failures)
        _phase("wide", phase_wide, failures)
        # last: the test session's conftest enables x64 for the process
        _phase("card tests", phase_card_tests, failures)
    if failures:
        print(f"chip_smoke: FAILED {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
