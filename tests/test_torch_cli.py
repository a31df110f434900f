"""The port's command-line entry points (det3d_tpu_torch/cli.py) and the
utilities that came with them, on the CPU (``--device cpu``): train and
test against the public API, the three data preparations against the
JAX package's, the device flag and an incomplete set of the ranks'
flags (ranks themselves: tests/test_torch_dist.py), ``python -m
det3d_tpu_torch.cli``, the packaging of the scripts and the native
sources, ``load_weights`` from a ``file://`` URL, and fileio, cloudpath
and config_tool against the JAX package's copies.

Training runs utils/mini_kitti.py's mini config over an 8-scene tree,
written to a JSON config file for the CLI. Its loader runs in-process on
the global ``np.random``, which each side seeds.
"""

import json
import os
import pickle
import subprocess
import sys
import tomllib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from det3d_tpu.cli import _kitti_data_prep as jkitti_prep
from det3d_tpu.cli import _lyft_data_prep as jlyft_prep
from det3d_tpu.cli import _nuscenes_data_prep as jnusc_prep
from det3d_tpu.runtime.checkpoint import save_weights_npz
from det3d_tpu.utils import cloudpath as jcloudpath
from det3d_tpu.utils import config_tool as jconfig_tool
from det3d_tpu.utils import fileio as jfileio
from det3d_tpu_torch import cli
from det3d_tpu_torch.apis.train import (build_stack, eval_detector,
                                        init_state, train_detector)
from det3d_tpu_torch.runtime.checkpoint import load_weights, state_tensors
from det3d_tpu_torch.utils import cloudpath, config_tool, fileio
from det3d_tpu_torch.utils import mini_kitti as mk
from det3d_tpu_torch.utils import mini_nuscenes as mn
from det3d_tpu_torch.utils.config import Config
from tests import mini_kitti as jmk
from tests import mini_nuscenes as jmn
from tests.test_torch_kitti_data import assert_same
from tests.test_torch_nusc_data import random_variables, rooted

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_kitti")
    mk.make_tree(root, n_scenes=8)
    return root


def write_config(path, cfg):
    path.write_text(json.dumps(cfg))
    return str(path)


def mini(root, epochs):
    cfg = mk.mini_config(str(root), total_epochs=epochs)
    cfg["tensorboard"] = False
    return cfg


# ---------------------------------------------------------------------------
# train and test
# ---------------------------------------------------------------------------

def test_train_main_equals_train_detector(kitti, tmp_path):
    """``train`` writes the checkpoints that train_detector writes from
    the same seed and stream, with the config file's text in their
    metadata; ``--resume_from`` continues the epochs."""
    conf = write_config(tmp_path / "mini.json", mini(kitti, 1))
    work = tmp_path / "cli"
    np.random.seed(0)
    assert cli.main(["train", conf, "--work_dir", str(work),
                     "--device", "cpu"]) == 0
    np.random.seed(0)
    trainer = train_detector(mini(kitti, 1), work_dir=str(tmp_path / "api"),
                             device="cpu")
    blob = torch.load(work / "ckpt" / "epoch_1.pt", weights_only=True)
    want = state_tensors(trainer.state)
    assert sorted(blob) == sorted(want)
    for k, v in want.items():
        assert torch.equal(blob[k], v.detach()), k
    meta = json.loads((work / "ckpt" / "det3d_tpu_meta.json").read_text())
    assert meta["config"] == Path(conf).read_text() and meta["epoch"] == 1

    conf2 = write_config(tmp_path / "mini2.json", mini(kitti, 2))
    assert cli.main(["train", conf2, "--work_dir", str(work),
                     "--resume_from", str(work), "--device", "cpu"]) == 0
    assert sorted(p.name for p in (work / "ckpt").glob("*.pt")) == [
        "epoch_1.pt", "epoch_2.pt"]


def test_test_main_prints_the_official_result(kitti, tmp_path, capsys):
    """``test`` restores the work dir's latest checkpoint into a state as
    wide as an example of the split and prints what eval_detector gives
    on the trained state."""
    cfg = mini(kitti, 1)
    conf = write_config(tmp_path / "mini.json", cfg)
    work = tmp_path / "work"
    np.random.seed(1)
    trainer = train_detector(cfg, work_dir=str(work), device="cpu")
    results, _ = eval_detector(mini(kitti, 1), trainer.state, device="cpu")
    capsys.readouterr()
    assert cli.main(["test", conf, str(work), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint @ epoch 1" in out
    assert results["results"]["official"] in out
    assert "Car AP" in out
    assert (work / "kitti_eval.txt").is_file()


@pytest.mark.parametrize("argv", [["train", "CONF"],
                                  ["test", "CONF", "WORK"]])
def test_mains_need_a_card_unless_asked_for_the_cpu(kitti, tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    conf = write_config(tmp_path / "mini.json", mini(kitti, 1))
    argv = [{"CONF": conf, "WORK": str(tmp_path)}.get(a, a) for a in argv]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


def test_create_data_takes_no_device(tmp_path):
    """The data preparation runs on the host alone: it needs no card and
    has no ``--device``."""
    mn.make_tree(tmp_path)
    argv = ["create_data", "lyft_data_prep", "--root_path", str(tmp_path),
            "--version", mn.VERSION, "--nsweeps", "3"]
    with pytest.raises(SystemExit):
        cli.main(argv + ["--device", "cpu"])
    assert cli.main(argv) == 0
    assert (tmp_path / "lyft_infos_train_03sweeps.pkl").is_file()


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num_processes", "2"],
                                  ["--process_id", "0"]])
def test_distributed_flags_raise(kitti, tmp_path, flag, capsys):
    """A run over ranks needs the three flags together (ranks over gloo:
    tests/test_torch_dist.py); one alone is an error of the command line,
    before anything is built."""
    conf = write_config(tmp_path / "mini.json", mini(kitti, 1))
    with pytest.raises(SystemExit):
        cli.main(["train", conf, "--device", "cpu"] + flag)
    assert "go together" in capsys.readouterr().err


def test_unknown_command_prints_usage(capsys):
    assert cli.main([]) == 2
    assert cli.main(["serve"]) == 2
    assert "train,test,create_data" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the data preparations
# ---------------------------------------------------------------------------

def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*")
                  if p.is_file())


def test_create_data_kitti_equals_jax(tmp_path):
    """Infos, reduced point clouds and gt database over a raw mini-KITTI
    tree (its scenes only), as the JAX package's preparation writes
    them."""
    ours, ref = tmp_path / "port", tmp_path / "jax"
    for root, m in ((ours, mk), (ref, jmk)):
        rng = np.random.RandomState(0)
        for idx in range(4):
            boxes = np.array([[9.0 + idx, 1.0, -1.0, 1.7, 4.1, 1.6, 0.2]])
            m.write_scene(root, idx, boxes, ["Car"], rng)
        (root / "ImageSets").mkdir()
        (root / "ImageSets" / "train.txt").write_text("0\n1\n")
        (root / "ImageSets" / "val.txt").write_text("2\n3\n")
    assert cli.main(["create_data", "kitti_data_prep", "--root_path",
                     str(ours)]) == 0
    jkitti_prep(str(ref))
    files = _files(ref)
    assert _files(ours) == files
    assert any(f.parts[0] == "gt_database" for f in files)
    assert any("velodyne_reduced" in f.parts for f in files)
    for f in files:
        if f.suffix == ".pkl":
            assert_same(rooted(pickle.load(open(ours / f, "rb")), ours),
                        rooted(pickle.load(open(ref / f, "rb")), ref))
        else:
            assert (ours / f).read_bytes() == (ref / f).read_bytes(), f


@pytest.mark.parametrize("which", ["nuscenes", "lyft"])
def test_create_data_nuscenes_and_lyft_equal_jax(tmp_path, which):
    """``create_data nuscenes_data_prep`` (3-sweep infos and the gt
    database) and ``lyft_data_prep`` over mini trees, as the JAX
    package's write them."""
    ours, ref = tmp_path / "port", tmp_path / "jax"
    mn.make_tree(ours)
    jmn.make_tree(ref)
    np.random.seed(0)
    assert cli.main(["create_data", f"{which}_data_prep", "--root_path",
                     str(ours), "--version", mn.VERSION, "--nsweeps",
                     "3"]) == 0
    np.random.seed(0)
    (jnusc_prep if which == "nuscenes" else jlyft_prep)(
        str(ref), jmn.VERSION, 3)
    files = _files(ref)
    assert _files(ours) == files
    pkls = [f for f in files if f.suffix == ".pkl"]
    assert len(pkls) == (3 if which == "nuscenes" else 2)
    for f in files:
        if f.suffix == ".pkl":
            assert_same(rooted(pickle.load(open(ours / f, "rb")), ours),
                        rooted(pickle.load(open(ref / f, "rb")), ref))
        else:
            assert (ours / f).read_bytes() == (ref / f).read_bytes(), f


def test_module_entry_point_runs(tmp_path):
    """``python -m det3d_tpu_torch.cli create_data ...`` in a process of
    its own."""
    mn.make_tree(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, "-m", "det3d_tpu_torch.cli", "create_data",
         "lyft_data_prep", "--root_path", str(tmp_path), "--version",
         mn.VERSION, "--nsweeps", "3"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=120)
    assert run.returncode == 0, run.stderr
    assert "lyft train infos: 4, val: 4" in run.stdout
    assert (tmp_path / "lyft_infos_val_03sweeps.pkl").is_file()


def test_pyproject_names_the_scripts_and_native_sources():
    """The console scripts point at the mains, and the package data takes
    every native source that csrc builds at first use."""
    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    scripts = meta["project"]["scripts"]
    for name, main in (("train", "train_main"), ("test", "test_main"),
                       ("create-data", "create_data_main")):
        assert scripts[f"det3d-tpu-torch-{name}"] == \
            f"det3d_tpu_torch.cli:{main}"
        assert callable(getattr(cli, main))
    globs = meta["tool"]["setuptools"]["package-data"]["det3d_tpu_torch"]
    csrc = REPO / "det3d_tpu_torch"
    data = {p for g in globs for p in csrc.glob(g)}
    sources = {p for p in (csrc / "csrc").iterdir()
               if p.suffix in (".cu", ".cc")}
    assert sources and sources <= data
    assert {p.name for p in sources} >= {"hostplan.cc", "pointops.cc"}


# ---------------------------------------------------------------------------
# weights from a URL
# ---------------------------------------------------------------------------

def test_load_weights_from_a_file_url(kitti, tmp_path, monkeypatch):
    """A JAX ``.npz`` served by a ``file://`` URL: fetched once into the
    cache under HOME, loaded as the file itself loads; a second load
    reads the cache (the source gone)."""
    from det3d_tpu.apis.train import build_stack as jbuild_stack
    from det3d_tpu.apis.train import batch_to_device as jbatch_to_device
    from det3d_tpu.parallel.train import build_example as jbuild_example
    from det3d_tpu_torch.datasets import build_dataset
    from det3d_tpu_torch.datasets.loader.loader import collate

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    cfg = mini(kitti, 1)
    cfg["model"]["reader"]["precision"] = "fp32"
    cfg["model"]["neck"]["precision"] = "fp32"
    jm, jvg = jbuild_stack(json.loads(json.dumps(cfg)))[:2]
    batch = collate([build_dataset(cfg["data"]["val"])[0]])

    def init(b):
        ex = jbuild_example(b, jvg, [], [], with_targets=False)
        return jm.init(jax.random.PRNGKey(0), ex["voxels"],
                       ex["num_points_per_voxel"], ex["coordinates"],
                       train=False)
    shapes = jax.eval_shape(init, jbatch_to_device(batch))
    var = random_variables({k: shapes[k] for k in ("params",
                                                   "batch_stats")}, 3)
    src = tmp_path / "serve" / "weights.npz"
    src.parent.mkdir()
    save_weights_npz(types.SimpleNamespace(**var), str(src))

    def fresh():
        model = build_stack(cfg, "cpu")[0]
        return init_state(cfg, model, 1)[0]
    want = load_weights(fresh(), str(src)).model.state_dict()
    got = load_weights(fresh(), src.as_uri()).model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    cached = list((tmp_path / "home" / ".cache" / "det3d_tpu_torch")
                  .iterdir())
    assert [p.name.split("_", 1)[1] for p in cached] == ["weights.npz"]
    src.unlink()
    again = load_weights(fresh(), src.as_uri()).model.state_dict()
    for k, v in want.items():
        assert torch.equal(again[k], v), k


# ---------------------------------------------------------------------------
# fileio, cloudpath and config_tool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["json", "pkl", "pickle"]
                         + (["yaml"] if fileio._HAS_YAML else []))
def test_fileio_round_trips_as_jax(tmp_path, fmt):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None, "d": True}}
    path = tmp_path / f"obj.{fmt}"
    fileio.dump(obj, str(path))
    assert fileio.load(path) == obj == jfileio.load(str(path))
    assert fileio.dump(obj, file_format=fmt) == \
        jfileio.dump(obj, file_format=fmt)
    with open(path, "rb" if fmt in ("pkl", "pickle") else "r") as f:
        assert fileio.load(f, file_format=fmt) == obj
    with pytest.raises(TypeError):
        fileio.load(tmp_path / "obj.txt")


def test_fileio_progress_and_timer(capsys):
    assert fileio.track_progress(lambda x, k=0: x * x + k, [1, 2, 3],
                                 k=1) == [2, 5, 10]
    assert list(fileio.track_iter_progress(([4, 5], 2))) == [4, 5]
    out = capsys.readouterr().out
    assert "3/3" in out and "2/2" in out
    t = fileio.Timer()
    assert 0 <= t.since_last_check() <= t.since_start()


def test_cloudpath_gate_and_pure_paths():
    """Local paths come back as pathlib; ``oss://`` needs the oss2 SDK and
    raises without it, as the JAX package's copy does; the pure-path
    surface equals the JAX package's OSSPath."""
    assert cloudpath.smart_path("/data/x.bin") == Path("/data/x.bin")
    assert cloudpath.is_oss_path("oss://b/k") and \
        not cloudpath.is_oss_path("/b/k")
    if not cloudpath._HAS_OSS:
        with pytest.raises(ImportError, match="oss2"):
            cloudpath.smart_path("oss://bucket/key")
    for url in ("oss://bucket/a/b/c.tar.gz", "oss://bucket/", "oss://b/k"):
        ours, ref = cloudpath.OSSPath(url), jcloudpath.OSSPath(url)
        for attr in ("name", "stem", "suffix"):
            assert getattr(ours, attr) == getattr(ref, attr), (url, attr)
        assert str(ours.parent) == str(ref.parent)
        assert str(ours / "d.bin") == str(ref / "d.bin")


@pytest.mark.parametrize("name", ["nusc_cbgs_voxelnet", "nusc_pointpillars",
                                  "lyft_cbgs_voxelnet", "kitti_car_second",
                                  "kitti_car_pointpillars"])
def test_config_tool_equals_jax(name):
    model = Config.fromfile(REPO / "configs" / f"{name}.py")["model"]
    assert config_tool.get_downsample_factor(model) == \
        jconfig_tool.get_downsample_factor(model)
