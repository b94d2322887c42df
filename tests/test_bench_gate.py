"""Perf-regression gate logic (bench.py --check).

The reference asserts no perf thresholds at all (SURVEY.md section 4 —
``@time`` observed-only); the gate here must actually bite: floors are
pinned as median-of-N with recorded spread, and the tolerance is
max(2*spread, 10%). A deliberate 20% slowdown injected into the DI
metric must be caught.
"""

import json
import sys

import pytest

sys.path.insert(0, __file__.rsplit("/tests/", 1)[0])
import bench  # noqa: E402


def _floors(tmp_path, entries_low=None, entries_high=None, backend="gpu"):
    path = tmp_path / "floor.json"
    path.write_text(json.dumps({
        "backend": backend,
        "higher_is_better": entries_high or {},
        "lower_is_better": entries_low or {},
    }))
    return str(path)


def test_injected_di_slowdown_is_caught(tmp_path):
    """The dry regression drill: a 20% DI slowdown vs a tight floor
    (spread 2% -> tolerance 10%) must fail the gate."""
    path = _floors(tmp_path, entries_low={
        "family_di_s": {"value": 1.0, "spread": 0.02}})
    measured = {"family_di_s": 1.0 * 1.20}          # injected +20%
    assert bench.check_floors(measured, path, "gpu") == 1
    # within tolerance: 8% is inside max(2*2%, 10%)
    assert bench.check_floors({"family_di_s": 1.08}, path, "gpu") == 0


def test_spread_widens_tolerance(tmp_path):
    """A noisy leg (spread 9%) gets tolerance 18%: 15% slower passes,
    20% fails."""
    path = _floors(tmp_path, entries_low={
        "deep_msa_s": {"value": 2.0, "spread": 0.09}})
    assert bench.check_floors({"deep_msa_s": 2.0 * 1.15}, path, "gpu") == 0
    assert bench.check_floors({"deep_msa_s": 2.0 * 1.20}, path, "gpu") == 1


def test_higher_is_better_direction(tmp_path):
    path = _floors(tmp_path, entries_high={
        "pairs_per_s": {"value": 1e10, "spread": 0.01}})
    assert bench.check_floors({"pairs_per_s": 0.95e10}, path, "gpu") == 0
    assert bench.check_floors({"pairs_per_s": 0.85e10}, path, "gpu") == 1


def test_legacy_scalar_floor_keeps_blanket_tolerance(tmp_path):
    """Old-format scalar floors (no recorded spread) keep the historic
    15% blanket so an un-repinned file still gates."""
    path = _floors(tmp_path, entries_low={"family_frob_s": 1.0})
    assert bench.check_floors({"family_frob_s": 1.14}, path, "gpu") == 0
    assert bench.check_floors({"family_frob_s": 1.16}, path, "gpu") == 1


def test_backend_mismatch_refused(tmp_path):
    path = _floors(tmp_path, backend="cpu",
                   entries_low={"family_di_s": {"value": 1.0,
                                                "spread": 0.0}})
    # floors recorded on another platform must be refused
    assert bench.check_floors({"family_di_s": 0.5}, path, "gpu") == 1


def test_pin_floors_median_and_spread():
    samples = [
        {"family_di_s": 1.00, "pairs_per_s": 9.0e9},
        {"family_di_s": 1.10, "pairs_per_s": 10.0e9},
        {"family_di_s": 0.98, "pairs_per_s": 10.4e9},
    ]
    pinned = bench.pin_floors(samples)
    assert pinned["family_di_s"]["value"] == 1.00
    assert pinned["family_di_s"]["spread"] == pytest.approx(0.10)
    assert pinned["pairs_per_s"]["value"] == 10.0e9
    assert pinned["pairs_per_s"]["spread"] == pytest.approx(0.10)


def test_every_floor_leg_is_measured():
    """measure_all's metric keys and the floor-file key lists must stay
    in sync — a renamed leg would otherwise silently drop out of the
    gate ('not enforced')."""
    import inspect

    src = inspect.getsource(bench.measure_all)
    for key in bench._HIGHER + bench._LOWER:
        assert f'"{key}"' in src, key
