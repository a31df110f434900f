"""The traffic generator repeats exactly for a seed, and every seed gets
the same set of sizes: every mix of the manifest's cells, with the
configuration of its first cell (tiny.mixes)."""

import numpy as np
import pytest

from benchmark.core import traffic
from benchmark.tests import tiny

CFG = tiny.mixes()
MIXES = list(CFG)
BIG = 2 ** 31 + 11


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_repeats_exactly(mix):
    m, cfg = tiny.tiny_mix(mix), tiny.tiny_config(CFG[mix])
    a, b = traffic.pool(m, cfg, BIG), traffic.pool(m, cfg, BIG)
    assert len(a) == len(b) == m["pool"] // (
        traffic.batch_size(m, cfg) if m["mode"] == "serve" else 1)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_scans_in_another_order(mix):
    m, cfg = tiny.tiny_mix(mix), tiny.tiny_config(CFG[mix])
    a, b = traffic.pool(m, cfg, 1), traffic.pool(m, cfg, BIG)

    def scans(pool):
        pts = np.concatenate([x["points"] for x in pool])
        return sorted(p.tobytes() for p in pts)
    assert scans(a) == scans(b)
    assert not all(np.array_equal(x["points"], y["points"])
                   for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_points_fit_the_configuration(mix):
    m, cfg = tiny.tiny_mix(mix), tiny.tiny_config(CFG[mix])
    cols = cfg["model"]["reader"]["num_input_features"]
    for x in traffic.pool(m, cfg, 5):
        assert x["points"].shape[1:] == (m["cap_points"], cols)
        assert x["points"].dtype == np.float32
        lo, hi = m["valid_points"]
        assert ((x["num_points"] >= lo) & (x["num_points"] <= hi)).all()
        if "sweeps" in m:
            t = x["points"][0, :x["num_points"][0], 4]
            assert set(np.round(t / 0.05).astype(int)) <= set(range(10))
        if m["mode"] == "train":
            assert x["gt_valid"].any(1).all()


@pytest.mark.parametrize("key,value", [("clients", 4), ("loop", "open"),
                                       ("scene", "boxes"),
                                       ("mode", "replay")])
def test_a_mix_asking_for_what_nothing_runs_is_refused(key, value):
    m, cfg = tiny.tiny_mix("serve-points-16k"), tiny.tiny_config(
        "second-kitti-car")
    m[key] = value
    with pytest.raises(ValueError, match=key if key != "mode" else value):
        traffic.pool(m, cfg, 1)
