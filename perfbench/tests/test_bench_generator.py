"""The one generator draws each mix's requests from the seed alone."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import generator

HERE = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))
CONFIG = {"market": {"S0": 100.0, "T": 1.0, "r": 0.03, "q": 0.0,
                     "sigma": 0.2}}
BIG_SEED = 2**31 + 12345


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mix", MIXES)
def test_requests_repeat_per_seed(mix):
    one = generator.Requests(CONFIG, _mix(mix), BIG_SEED, 0).take(5)
    two = generator.Requests(CONFIG, _mix(mix), BIG_SEED, 0).take(5)
    for a, b in zip(one, two):
        _same(a, b)
    other = generator.Requests(CONFIG, _mix(mix), BIG_SEED + 1, 0).take(5)
    assert [r["mc_seed"] for r in other] != [r["mc_seed"] for r in one]
    warm = generator.Requests(CONFIG, _mix(mix), BIG_SEED, 1).take(5)
    assert [r["mc_seed"] for r in warm] != [r["mc_seed"] for r in one]
    for r in one:
        assert 0 <= r["mc_seed"] <= generator.MAX_MC_SEED


def test_draws_stay_in_their_ranges():
    reqs = generator.Requests(CONFIG, _mix("barrier_lv"), 7, 0).take(200)
    K = np.array([r["K"] for r in reqs])
    B = np.array([r["barrier"] for r in reqs])
    assert K.min() >= 90 and K.max() <= 110 and B.min() >= 120 \
        and B.max() <= 140
    assert all(r["T"] == 1.0 and r["kind"] == "call" for r in reqs)
    assert generator.contracts(reqs[0]) == 1


def test_book_groups():
    req = generator.Requests(CONFIG, _mix("book"), 3, 0).next()
    assert generator.contracts(req) == 1000
    np.testing.assert_array_equal(req["K"], np.linspace(50.0, 150.0, 1000))
    assert list(req["kind"]) == ["put"] * 1000
    assert 98.0 <= req["S0"] <= 102.0
    assert (req["T"], req["r"], req["q"], req["sigma"]) == (1.0, 0.03, 0.0,
                                                            0.2)


def test_group_specs():
    mix = {"groups": [{"n": 5, "K": {"linspace": [1.0, 5.0]},
                       "kind": {"cycle": ["call", "put"]},
                       "S0": {"uniform": [95.0, 105.0]}},
                      {"n": 2, "K": 9.0, "kind": "put", "S0": 100.0}]}
    req = generator.Requests(CONFIG, mix, 3, 0).next()
    assert req["K"].tolist() == [1.0, 2.0, 3.0, 4.0, 5.0, 9.0, 9.0]
    assert list(req["kind"]) == ["call", "put", "call", "put", "call",
                                 "put", "put"]
    assert 95 <= req["S0"][:5].min() and req["S0"][:5].max() <= 105
    assert req["S0"][5:].tolist() == [100.0, 100.0]


def test_negative_and_large_seeds():
    for seed in (-5, 0, 2**40 + 3):
        assert isinstance(generator.stream(seed, 0).integers(10), np.int64)
