"""Benchmark: reweighting throughput (the reference's hot loop #1) and
the other per-layer cells, on an NVIDIA card.

Prints ONE JSON line on stdout:
  {"metric": "...", "value": N, "unit": "seq-pairs/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>"}

The metric is all-pairs similarity throughput of the platform's row
statistics (``ops/dispatch.kernels()``: int8 one-hot GEMMs) — the
replacement for the reference's threaded bit-packed Hamming loop
(SURVEY.md 2.5). The reference publishes no numbers, so ``vs_baseline``
is measured against a CPU baseline run in-process: NumPy/BLAS one-hot
sgemm, the strongest same-machine stand-in for the single-node reference.
Every timed region ends in ``block_until_ready``.

The run needs a GPU: on any other platform it exits non-zero and prints
no result. Detail lines go to stderr.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# scratch space inside the checkout (listed in .gitignore)
WORK = os.path.join(REPO, ".work")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _timed(fn, args_per_rep):
    """Median wall time of ``fn(*args)`` over ``args_per_rep`` (a list of
    argument tuples, one per timed rep); the first tuple also warms up."""
    import jax

    jax.block_until_ready(fn(*args_per_rep[0]))
    times = []
    for args in args_per_rep:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def bench_row_stats(M=32768, N=384, q=21, reps=5):
    import jax
    import jax.numpy as jnp
    from gaussdca_tpu.ops import dispatch

    row_stats = dispatch.kernels()["row_stats_fn"]
    rng = np.random.default_rng(0)
    Zs = [jnp.asarray(rng.integers(1, q + 1, size=(M, N), dtype=np.int8))
          for _ in range(reps)]
    thresh = jnp.asarray(float(int(0.2 * N)), jnp.float32)
    fn = jax.jit(lambda z: row_stats(z, thresh, q))
    t, times = _timed(fn, [(z,) for z in Zs])
    pairs = M * (M - 1) / 2
    log(f"[bench] row stats M={M} N={N} q={q} "
        f"impl={getattr(row_stats, '__name__', repr(row_stats))} "
        f"median={t:.4f}s (all: {[round(x, 4) for x in times]}) -> "
        f"{pairs / t:.3e} pairs/s "
        f"({2 * M * M * N * q / t / 1e12:.1f} TOP/s one-hot-equiv)")
    return pairs / t


def bench_solve(Ns=8000, reps=3):
    """Covariance-solve throughput (hot loop #2): SPD inverse at the
    large-golden scale (N=400, s=20 -> 8000^2), f32 HIGHEST."""
    import jax
    import jax.numpy as jnp
    from gaussdca_tpu.solve.cholesky import spd_inverse

    @jax.jit
    def inv(A):
        with jax.default_matmul_precision("highest"):
            return spd_inverse(A)

    def make(seed):
        # host-side np array; device_put happens one rep at a time below
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((Ns, 256)).astype(np.float32)
        C = (A @ A.T) / 256
        C[np.arange(Ns), np.arange(Ns)] += Ns
        return C

    # one device-resident input at a time: at Ns=20000 a single f32
    # input is 1.6 GB next to the solve's own ~5 n^2 working buffers
    C = jnp.asarray(make(0))
    jax.block_until_ready(inv(C))  # compile
    del C
    times = []
    for s in range(1, reps + 1):
        C = jax.block_until_ready(jnp.asarray(make(s)))
        t0 = time.perf_counter()
        jax.block_until_ready(inv(C))
        times.append(time.perf_counter() - t0)
        del C
    t = float(np.median(times))
    # dpotrf+dpotri-equivalent flops: (1/3 + 2/3) * Ns^3 ~= Ns^3; the
    # Newton refinement step adds 4 Ns^3 matmul flops
    flops = Ns ** 3 + 4 * Ns ** 3
    log(f"[bench] covariance solve Ns={Ns}: {t:.3f}s -> "
        f"{flops / t / 1e12:.1f} TFLOP/s (f32 HIGHEST, incl. 1 Newton "
        f"refinement)")
    return flops / t


def _pipeline_cell(M, N, q, *, score, theta_is_auto, pc, theta, seed,
                   reps):
    """Median end-to-end time of the single-program pipeline (the jitted
    ``api._scores_jit``) over ``reps`` fresh token matrices."""
    import jax.numpy as jnp
    from gaussdca_tpu.api import _scores_jit

    rng = np.random.default_rng(seed)
    Zs = [(jnp.asarray(rng.integers(1, q + 1, size=(M, N), dtype=np.int8)),)
          for _ in range(reps + 1)]

    def run(Z):
        return _scores_jit(
            Z, jnp.asarray(pc, jnp.float32), jnp.asarray(theta, jnp.float32),
            q=q, score=score, theta_is_auto=theta_is_auto,
            dtype_name="float32", use_pallas=True)

    t, _ = _timed(run, Zs)
    return t


def bench_family(M=5000, N=200, q=21, reps=3):
    """s/family end-to-end, a mid-size Pfam family (theta=0.2)."""
    out = {score: _pipeline_cell(M, N, q, score=score, theta_is_auto=False,
                                 pc=0.2, theta=0.2, seed=2, reps=reps)
           for score in ("frob", "DI")}
    log(f"[bench] end-to-end s/family (M={M} N={N} theta=0.2): "
        f"frob {out['frob']:.4f}s, DI {out['DI']:.4f}s")
    return out


def bench_deep(M=100_000, N=200, q=21, reps=3):
    """Deep-MSA end-to-end: auto-theta + frob at M=1e5 (the O(M^2 N q)
    distance pass runs exactly once: auto-theta is a closed form)."""
    t = _pipeline_cell(M, N, q, score="frob", theta_is_auto=True, pc=0.8,
                       theta=0.0, seed=3, reps=reps)
    log(f"[bench] deep-MSA e2e (M={M} N={N} auto-theta frob): {t:.4f}s")
    return t


def bench_family_n1000(M=1024, N=1000, q=21, reps=3):
    """Wide-family DI end-to-end (M=1024, N=1000): the DI stage's
    P = 499,500 pair integrals dominate."""
    t = _pipeline_cell(M, N, q, score="DI", theta_is_auto=False, pc=0.2,
                       theta=0.2, seed=5, reps=reps)
    log(f"[bench] wide-family e2e (M={M} N={N} DI): {t:.4f}s")
    return t


def bench_ingest(M=100_000, N=400, reps=4):
    """Host ingest throughput (Mtok/s) of the native parser on a deep
    gzipped MSA. None when the native library is unavailable (the leg
    is then reported, not enforced)."""
    from gaussdca_tpu.io import native

    if not native.available():
        log("[bench] ingest leg skipped: native parser unavailable")
        return None
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"bench_ingest_{M}x{N}.fasta.gz")
    if not os.path.exists(path):
        import gzip

        log(f"[bench] synthesizing {path} (one-time)")
        rng = np.random.default_rng(0)
        aa = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY-", dtype=np.uint8)
        toks = aa[rng.integers(0, 21, size=(M, N))]
        tmp = path + ".tmp"
        with gzip.open(tmp, "wb", compresslevel=6) as fh:
            for i in range(M):
                fh.write(b">seq%d/1-%d\n" % (i, N))
                row = toks[i].tobytes()
                for j in range(0, N, 80):
                    fh.write(row[j:j + 80] + b"\n")
        os.replace(tmp, path)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        tokens, _, _, _ = native.parse_fasta(path, 0.9)
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    mtok_s = tokens.size / t / 1e6
    log(f"[bench] host ingest ({M}x{N} gzipped FASTA, "
        f"{native.backend()}): median {t:.3f}s -> {mtok_s:.0f} Mtok/s "
        f"(all: {[round(x, 3) for x in times]})")
    return mtok_s


def bench_cpu_baseline(M=4096, N=384, q=21, reps=3):
    """NumPy/BLAS one-hot sgemm + threshold counts: the CPU stand-in for
    the reference's threaded Hamming loop, on this same host. Best of
    ``reps`` (the fastest run is the most conservative speedup ratio)."""
    rng = np.random.default_rng(0)
    Z = rng.integers(1, q + 1, size=(M, N), dtype=np.int8)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        E = np.zeros((M, N * q), dtype=np.float32)
        np.put_along_axis(E.reshape(M, N, q),
                          (Z - 1)[:, :, None].astype(np.int64), 1.0, axis=2)
        D = E @ E.T
        thresh = float(int(0.2 * N))
        below = ((N - D) < thresh).sum(1)
        _ = 1.0 / (1.0 + np.maximum(below - 1, 0))
        best = min(best, time.perf_counter() - t0)
    pairs = M * (M - 1) / 2
    log(f"[bench] cpu-baseline (numpy/BLAS one-hot sgemm, best of {reps}) "
        f"M={M} N={N}: {best:.3f}s -> {pairs / best:.3e} pairs/s")
    return pairs / best


def _floor_entry(floor):
    """(value, tolerance) from a floor entry.

    {"value": v, "spread": s} is pinned as the median of >= 3 solo runs
    with s = max relative deviation from that median; the gate bites at
    max(2*spread, 10%). Scalar floors (no recorded spread) keep a
    blanket 15%."""
    if isinstance(floor, dict):
        return float(floor["value"]), max(
            2.0 * float(floor.get("spread", 0.0)), 0.10)
    return float(floor), 0.15


def check_floors(measured: dict, floor_path: str, platform: str) -> int:
    """Perf regression gate: fail when any measured metric regresses
    beyond its pinned floor's tolerance (see ``_floor_entry``). Floors
    recorded on another platform are refused. Returns an exit code."""
    if not os.path.exists(floor_path):
        log(f"[bench --check] no floor file at {floor_path}; "
            "run with --update-floor first")
        return 1
    with open(floor_path) as fh:
        floors = json.load(fh)
    floor_platform = floors.get("backend")
    if floor_platform != platform:
        log(f"[bench --check] floor file was recorded on "
            f"'{floor_platform}' but this run is '{platform}' — refusing "
            "to compare; re-pin with --update-floor on the target")
        return 1
    rc = 0
    for key in measured:
        if key not in floors.get("higher_is_better", {}) and \
                key not in floors.get("lower_is_better", {}):
            log(f"[bench --check] metric '{key}' has no pinned floor "
                "(stale floor file?) — not enforced")
    for direction, sign in (("higher_is_better", 1.0),
                            ("lower_is_better", -1.0)):
        for key, floor in floors.get(direction, {}).items():
            got = measured.get(key)
            if got is None:
                log(f"[bench --check] pinned metric '{key}' was not "
                    "measured this run — not enforced")
                continue
            val, tol = _floor_entry(floor)
            lim = val * (1.0 - sign * tol)
            bad = got < lim if sign > 0 else got > lim
            if bad:
                rc = 1
            log(f"[bench --check] {key}: {got:.4g} vs floor {val:.4g} "
                f"(limit {lim:.4g}, tol {tol:.0%}) -> "
                f"{'REGRESSION' if bad else 'OK'}")
    return rc


def pin_floors(samples: list) -> dict:
    """Median + relative spread per metric from >= 1 full bench passes.

    ``samples``: list of measured dicts (one per solo pass). Spread is
    the max relative deviation from the median — recorded in the floor
    file so the gate's tolerance reflects the measured run-to-run
    variance instead of a blanket constant."""
    keys = sorted(set().union(*(s.keys() for s in samples)))
    out = {}
    for k in keys:
        xs = np.asarray([s[k] for s in samples if k in s], float)
        if len(xs) < len(samples):
            log(f"[bench --update-floor] metric '{k}' measured in only "
                f"{len(xs)}/{len(samples)} passes — pinning from those")
        med = float(np.median(xs))
        spread = float(np.max(np.abs(xs - med)) / med) if med else 0.0
        out[k] = {"value": round(med, 4), "spread": round(spread, 4)}
    return out


_HIGHER = ("pairs_per_s", "solve_flops_per_s", "solve20k_flops_per_s",
           "ingest_mtok_s")
_LOWER = ("family_frob_s", "family_di_s", "family_di_n1000_s",
          "deep_msa_s")


def measure_all():
    """One full bench pass -> measured-metric dict (all floor legs)."""
    value = bench_row_stats()
    solve = bench_solve()
    solve20k = bench_solve(Ns=20000)
    fam = bench_family()
    wide_di = bench_family_n1000()
    deep = bench_deep()
    ingest = bench_ingest()
    out = {
        "pairs_per_s": value,
        "solve_flops_per_s": solve,
        "solve20k_flops_per_s": solve20k,
        "family_frob_s": fam["frob"],
        "family_di_s": fam["DI"],
        "family_di_n1000_s": wide_di,
        "deep_msa_s": deep,
    }
    if ingest is not None:
        out["ingest_mtok_s"] = ingest
    return out


def card_description() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) on regression beyond each floor's "
                         "max(2*spread, 10%%) tolerance vs the pinned "
                         "floor file (recorded on the same platform)")
    ap.add_argument("--update-floor", action="store_true",
                    help="rewrite the floor file from --floor-reps full "
                         "solo passes (median + recorded spread)")
    ap.add_argument("--floor-reps", type=int, default=3,
                    help="full bench passes for --update-floor (>= 3 "
                         "recommended; the gate tolerance comes from the "
                         "measured spread)")
    ap.add_argument("--floor-file",
                    default=os.path.join(REPO, "bench_floor.json"))
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        log(f"[bench] needs a GPU; JAX found {len(devices)} {platform} "
            "device(s) — no result")
        return 2
    sys.path.insert(0, REPO)
    from gaussdca_tpu.cli import setup_compile_cache

    setup_compile_cache()
    card = card_description()
    device = {"platform": platform, "kind": devices[0].device_kind,
              "count": len(devices)}
    log(f"[bench] device {device}; card {card}")

    measured = measure_all()
    baseline = bench_cpu_baseline()
    print(json.dumps({
        "metric": "all-pairs reweighting throughput (int8 one-hot GEMM "
                  "row stats, M=32768 N=384 q=21)",
        "value": round(measured["pairs_per_s"], 1),
        "unit": "seq-pairs/s",
        "vs_baseline": round(measured["pairs_per_s"] / baseline, 2),
        "device": device,
        "card": card,
    }))

    if args.update_floor:
        samples = [measured]
        for k in range(max(args.floor_reps, 1) - 1):
            log(f"[bench] floor-pinning pass {k + 2}/{args.floor_reps}")
            samples.append(measure_all())
        pinned = pin_floors(samples)
        with open(args.floor_file, "w") as fh:
            json.dump({
                "comment": f"perf floors: median of {len(samples)} solo "
                           f"passes on {card}, with recorded relative "
                           "spread; bench.py --check fails beyond "
                           "max(2*spread, 10%)",
                "backend": platform,
                "higher_is_better": {k: pinned[k] for k in _HIGHER
                                     if k in pinned},
                "lower_is_better": {k: pinned[k] for k in _LOWER
                                    if k in pinned},
            }, fh, indent=1)
        log(f"[bench] floors written to {args.floor_file}")
    if args.check:
        return check_floors(measured, args.floor_file, platform)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
