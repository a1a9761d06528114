"""The frozen least-work counts give ``chip_smoke.py``'s bounds at its
sizes, and the book's count is the documented sum."""
import numpy as np
import pytest

from perfbench.counts import k3_book, k4_lv_path, k4_path_step, k8_ladder
from perfbench.counts.peaks import PEAK_BYTES, PEAK_OPS, bound


def test_peaks_are_the_data_sheets():
    assert PEAK_OPS == 67e12 and PEAK_BYTES == 3.35e12
    assert bound(67e9, 1.0) == (1.0, "operations")
    assert bound(1.0, 3.35e9) == (1.0, "bytes")


def test_asian_bound_is_chip_smokes():
    ms, by = bound(1_000_000 * 252 * k4_path_step.ops_k4_path_step(True,
                                                                   False),
                   8 + 96 + 84)
    assert by == "operations"
    assert round(ms, 4) == 0.4476


def test_desk_barrier_bound_is_chip_smokes():
    ops = 200_000 * k4_lv_path.ops_k4_lv_path(
        (0.25, 0.5, 1.0), float(np.float32(1.0 / 500)), 500)
    ms, by = bound(ops, 8 + 96 + 4 * 6 * 3 + 84)
    assert by == "operations"
    assert round(ms, 4) == 0.8418


def test_ladder_bound_is_chip_smokes():
    m, n_t, B = 511, 512, 1024
    ms, by = bound(k8_ladder.ops_k8_ladder(B, m, n_t),
                   4 * (n_t * (m + 1) + (m + 1) * B + 2 * B + 6))
    assert by == "operations"
    assert round(ms, 4) == 0.0401


def test_least_work_follows_the_request():
    traffic = {"sizes": {"n_paths": 1_000_000, "n_steps": 252,
                         "antithetic": True, "N_S": 512, "N_t": 512}}
    ops, _ = k4_path_step.least_work({}, traffic, {})
    assert ops == 1_000_000 * 252 * 119
    ops, n_bytes = k8_ladder.least_work({}, traffic, {"K": np.zeros(1024)})
    assert ops == k8_ladder.ops_k8_ladder(1024, 511, 512)
    assert n_bytes == 4 * (512 * 512 + 512 * 1024 + 2 * 1024 + 6)
    config = {"surface": {"slices": [{"T": 0.25}, {"T": 0.5}, {"T": 1.0}]}}
    lv = dict(traffic, sizes=dict(traffic["sizes"], n_paths=200_000,
                                  n_steps=500))
    ops, n_bytes = k4_lv_path.least_work(config, lv, {"T": 1.0})
    assert ops == 200_000 * k4_lv_path.ops_k4_lv_path(
        (0.25, 0.5, 1.0), float(np.float32(1 / 500)), 500)
    assert n_bytes == 8 + 96 + 72 + 84


@pytest.mark.parametrize("B", [1, 1000])
def test_book_count_leaves_out_the_source_work(B):
    """144 a base draw against the source's 150: Kahan steps are not the
    function's work."""
    assert k3_book.OPS_BOOK_DRAW == 144
    ops, n_bytes = k3_book.least_work(
        {}, {"sizes": {"n_paths": 1_000_000}}, {"K": np.zeros(B)})
    assert ops == B * 1_000_000 * 144
    assert n_bytes == 8 + 72 * B
