"""Static FLOP accounting per pipeline stage.

The per-stage wall/TFLOP counters the reference lacks (SURVEY.md
section 5): costs are closed-form in (M, N, q), so the batch log can
report achieved TFLOP/s per family without any device instrumentation.

The DI constants are NOT defined here: the Newton-Schulz iteration
count and the executed-lane planner are imported from score/di.py, the
module that owns the production dispatch — two rounds in a row a copy
here drifted from the code (iters 14 vs 20; tiled lanes uncounted) and
silently skewed every per-family DI TFLOP/s log.
tests/test_cli.py::test_di_flops_track_scoring_code pins the coupling.
"""

from __future__ import annotations

from typing import Dict


def pipeline_flops(M: int, N: int, q: int, *, score: str = "frob",
                   auto_theta: bool = True,
                   solve_refine_iters: int = 1,
                   bm: bool = True,
                   sharded: bool = False) -> Dict[str, float]:
    """Estimated FLOPs per stage for one family.

    Reweighting counts the one-hot-matmul formulation (2*M^2*N*q) for
    the ONE all-pairs pass the pipeline runs regardless of theta mode:
    auto-theta is the closed-form histogram reduction
    (sum of squared per-column state counts, O(M*N*q) — see
    stats/reweight.total_matches_closed_form), not a second distance
    pass. The solve counts potrf+potri-equivalent (Ns)^3 plus
    4*(Ns)^3 per Newton refinement.

    DI counts the PRODUCTION batch-minor path: per executed lane, the
    matmul-equivalent count score/di.py owns (``di.matmuls_per_lane``:
    rho/G lead matmuls + the Newton-Schulz loop with its trimmed
    first/last iterations + the elimination logdet, with the iteration
    count from ``di.bm_ns_iters()``) — times the lane count the dispatch
    will actually compute at this N (``di.planned_lane_count``: the
    dense-tile formulation executes up to ~2x the useful P = N(N-1)/2
    lanes at small N; the gathered path executes ~P plus chunk/lane
    alignment padding). Both follow the live GDCA_DI_TILED/GDCA_DI_RB
    knobs, so A/B runs are accounted under the plan they measured.
    """
    s = q - 1
    Ns = N * s
    auto_theta_flops = 3.0 * M * N * q if auto_theta else 0.0
    out = {
        "reweight": 2.0 * M * M * N * q + auto_theta_flops,
        "frequencies": 2.0 * M * Ns * Ns + 2.0 * M * Ns,
        "solve": (1.0 + 4.0 * solve_refine_iters) * Ns ** 3,
    }
    if score == "DI":
        from gaussdca_tpu.score.di import accounting_plan, matmuls_per_lane

        # ``bm``: the caller's coarse gate — the platform's batch-minor
        # choice + f32 + kernels on (the gemm scaffold otherwise: exact
        # chunk-padded lanes, FALLBACK_NS_ITERS fixed iterations; the
        # f64 monitored loop exits earlier, so its count is an upper
        # bound). ``sharded``: mesh runs execute the storage-sharded
        # bodies (exact-P lane slabs), not the mapped dense-tile plan.
        # The P-threshold leg of the real gate lives in
        # di.accounting_plan, next to the dispatch it mirrors —
        # accounting drifted from the executed graph when any constant
        # lived here.
        lanes, iters, trimmed = accounting_plan(N, requested_bm=bm,
                                                sharded=sharded)
        out["score"] = lanes * matmuls_per_lane(iters, trimmed=trimmed) \
            * 2.0 * s ** 3
    else:
        P = N * (N - 1) / 2
        out["score"] = P * 4.0 * s * s
    out["total"] = sum(out.values())
    return out
