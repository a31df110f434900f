"""BENCHMARK.json against its schema, and every piece of a cell
found by name, also for a cell added as data alone."""

import json
import re
import shutil

import pytest

from benchmark.core import harness
from benchmark.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_loads_with_the_schema_keys(manifest):
    assert set(manifest) == KEYS
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys_fit(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    names = []
    for key in ("end_to_end", "per_layer"):
        for m in manifest[key]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_what_it_must(manifest):
    e2e = manifest["end_to_end"]
    for w in manifest["workloads"]:
        mine = [m["name"] for m in e2e
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in manifest["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:                     # its `moves` is reported there
            assert m["moves"] in mine


def test_the_full_check_fits_the_limit(manifest):
    s = manifest["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("trace", [False, True])
def test_each_cell_is_found_by_name(manifest, trace):
    for w in manifest["workloads"]:
        cell = harness.Cell(ROOT, w["name"], trace)
        assert cell.cfg["name"] == w["config"]
        assert cell.mix["mode"] in ("serve", "train")
        assert cell.limits, f"no limits for {w['name']}"
        for m in cell.metrics:
            if trace:
                assert callable(cell.readers[m["name"]].read)


def test_a_cell_and_a_metric_added_as_data_are_found(tmp_path):
    root = tiny.write_tree(tmp_path)
    m = json.loads((root / "BENCHMARK.json").read_text())
    # a new mix, a new cell over it and a new per-layer metric: files
    # and entries only
    mix = json.loads((root / "benchmark/traffic/tiny-serve-points-16k.json")
                     .read_text())
    mix["valid_points"] = [2500, 3000]
    (root / "benchmark/traffic/tiny-serve-dense.json").write_text(
        json.dumps(mix))
    shutil.copy(root / "benchmark/limits/tiny-second-serve-points.json",
                root / "benchmark/limits/tiny-second-serve-dense.json")
    shutil.copy(root / "benchmark/metrics/host_call_ms.serve.py",
                root / "benchmark/metrics/host_call_ms_copy.serve.py")
    m["workloads"].append({"name": "tiny-second-serve-dense",
                           "config": "tiny-second-kitti-car",
                           "traffic": "tiny-serve-dense", "chips": 1,
                           "why": "denser scans"})
    m["per_layer"].append({"name": "host_call_ms_copy.serve", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "entry", "moves": "serve_p95_ms",
                           "workloads": ["tiny-second-serve-dense"]})
    for e in m["end_to_end"]:
        if "workloads" in e and "tiny-second-serve-points" in e[
                "workloads"]:
            e["workloads"].append("tiny-second-serve-dense")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.Cell(root, "tiny-second-serve-dense", True)
    assert cell.mix["valid_points"] == [2500, 3000]
    assert "host_call_ms_copy.serve" in cell.readers
    assert {x["name"] for x in harness.Cell(
        root, "tiny-second-serve-dense", False).metrics} == {
            "setup_s", "serve_scans_per_s", "serve_p95_ms"}


def test_a_missing_cell_fails():
    with pytest.raises(harness.Failure):
        harness.Cell(ROOT, "no-such-cell", False)


def test_a_configuration_added_as_data_runs_correct(tmp_path, capsys):
    """A copy of cbgs-nusc under a new name, a cell over it and a segment
    metric on that cell, added to a copy of the benchmark as files and
    entries only: the tiny tree cuts it by the default rule and a whole
    run on the CPU comes out correct."""
    src = tmp_path / "src"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(tiny.BENCH / sub, src / "benchmark" / sub)
    m = tiny.manifest()
    cfg = json.loads((tiny.BENCH / "configs" / "cbgs-nusc.json").read_text())
    cfg["name"] = "probe-nusc"
    (src / "benchmark/configs/probe-nusc.json").write_text(json.dumps(cfg))
    base = next(c for c in m["configs"] if c["name"] == "cbgs-nusc")
    m["configs"].append(dict(base, name="probe-nusc",
                             file="benchmark/configs/probe-nusc.json"))
    m["workloads"].append({"name": "probe-serve-points",
                           "config": "probe-nusc",
                           "traffic": "serve-points-300k-sweeps", "chips": 1,
                           "why": "the CBGS configuration under a new name"})
    for e in m["end_to_end"]:
        if "cbgs-serve-points" in e.get("workloads", []):
            e["workloads"].append("probe-serve-points")
    shutil.copy(src / "benchmark/metrics/dense_tail_ms.serve.py",
                src / "benchmark/metrics/probe_tail_ms.serve.py")
    m["per_layer"].append({"name": "probe_tail_ms.serve", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "middle, dense tail",
                           "moves": "serve_scans_per_s",
                           "workloads": ["probe-serve-points"]})
    (src / "BENCHMARK.json").write_text(json.dumps(m))
    assert ("probe-nusc", "serve-points-300k-sweeps", "serve") in \
        tiny.pairs(src)

    root = tiny.write_tree(tmp_path / "tiny", source=src)
    cut = json.loads((root / "benchmark/configs/tiny-probe-nusc.json")
                     .read_text())
    # the default rule: a range centred on the car, +-3.2 m, 500 voxels
    assert cut == dict(tiny.tiny_config("cbgs-nusc"), name="tiny-probe-nusc")
    assert cut["voxel_generator"]["max_voxel_num"] == 500
    assert cut["voxel_generator"]["range"][:2] == [-3.2, -3.2]
    cell = harness.Cell(root, "tiny-probe-serve-points", True)
    assert list(cell.readers) == ["probe_tail_ms.serve"]
    rc = harness.main(["--workload", "tiny-probe-serve-points", "--seed",
                       str(2 ** 31 + 29), "--seconds", "3", "--trace", "1"],
                      root=root, require_cuda=False)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    # no device trace on the CPU: the segment metric reads nothing
    assert line["metrics"] == {}
