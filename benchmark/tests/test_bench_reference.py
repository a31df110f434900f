"""At a tiny size on the CPU, the plain reference agrees with the
program's CPU path: the head's outputs from the same points and weights,
and one train step's loss and gradients. Each configuration of the
manifest is tested with the mix of each of its cells (tiny.pairs), its
reference module found as the harness finds it."""

import importlib

import numpy as np
import pytest
import torch

from benchmark.core import traffic, weights
from benchmark.reference import voxelnet
from benchmark.tests import tiny


def _pairs(mode):
    return [pytest.param(c, m, id=f"{c}-{m}")
            for c, m, md in tiny.pairs() if md == mode]


def reference(cfg):
    return importlib.import_module(f"benchmark.reference.{cfg['reference']}")


def _stack(cfg, params):
    from det3d_tpu_torch.apis.train import build_stack
    model, vg, asg, cids, test_cfg = build_stack(cfg, device="cpu")
    model.load_state_dict(params)
    return model, vg, asg, cids, test_cfg


def _setup(name, mix_name, seed=2 ** 31 + 3):
    cfg = tiny.tiny_config(name)
    mix = tiny.tiny_mix(mix_name)
    pool = traffic.pool(mix, cfg, seed)
    R = reference(cfg)
    arch = R.Arch(cfg)
    params = weights.make_params(arch, seed, "cpu")
    b = pool[0]
    weights.calibrate(R, arch, params, torch.as_tensor(b["points"][:1]),
                      torch.as_tensor(b["num_points"][:1]))
    return cfg, R, arch, params, pool


@pytest.mark.parametrize("name,mix", _pairs("serve"))
def test_heads_agree_with_the_program(name, mix):
    from det3d_tpu_torch.parallel.predict import make_predict_step
    cfg, R, arch, params, pool = _setup(name, mix)
    model, vg, asg, cids, test_cfg = _stack(cfg, params)
    seen = {}
    model.bbox_head.register_forward_hook(
        lambda m, a, o: seen.__setitem__("heads", o))
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    for b in pool[:2]:
        step(b)
        ref = R.forward(arch, params, torch.as_tensor(b["points"]),
                        torch.as_tensor(b["num_points"]))[0]
        for p, r in zip(seen["heads"], ref):
            assert p.keys() == r.keys()
            for k in r:
                scale = float(r[k].abs().max())
                assert float((p[k] - r[k]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("name,mix", _pairs("train"))
def test_one_train_step_agrees_with_the_program(name, mix):
    from det3d_tpu_torch.apis.train import init_state
    from det3d_tpu_torch.parallel.train import make_train_step
    from benchmark.core.train import reference_steps
    cfg, R, arch, params, pool = _setup(name, mix)
    model, vg, asg, cids, _ = _stack(cfg, params)
    state, _ = init_state(cfg, model, 100)
    step = make_train_step(state, vg, asg, cids)
    loss = float(step(pool[0])["loss"])
    b1 = R.one_cycle(cfg, 100)(0)[1]
    grad = [float(m.norm()) / (1 - b1) for m in state.tx.mu]
    names = [n for n, _ in model.named_parameters()]
    ref, _ = reference_steps(R, arch, cfg, params, names, pool[:1], 100,
                             torch.device("cpu"))
    assert abs(loss - ref["loss"][0]) <= 1e-5 * abs(ref["loss"][0])
    g, r = np.asarray(grad), np.asarray(ref["grad"])
    # sums in another order over a few hundred rows: up to 1.5e-2 seen
    assert np.max(np.abs(g - r) / np.maximum(r, np.median(r))) <= 5e-2


def test_rotated_iou_agrees_with_the_programs_geometry():
    from det3d_tpu_torch.core.geometry import rotated_iou_matrix
    g = torch.Generator().manual_seed(0)
    n = 120
    b = torch.cat([torch.rand(n, 2, generator=g) * 6,
                   0.5 + torch.rand(n, 2, generator=g) * 3,
                   (torch.rand(n, 1, generator=g) - 0.5) * 7], 1).double()
    ii, jj = torch.triu_indices(n, n, 1)
    want = rotated_iou_matrix(b, b)[ii, jj]
    got = voxelnet.rotated_iou(b[ii], b[jj])
    assert float((got - want).abs().max()) < 1e-9
    assert int((want > 0).sum()) > 100


def test_voxel_cap_keeps_the_configured_subset():
    """Hashed order keeps the smallest hashes, yxz the scan-line prefix."""
    for name, mix, mode in tiny.pairs():
        if mode != "serve":
            continue
        cfg = tiny.tiny_config(name)
        R = reference(cfg)
        cfg["voxel_generator"]["max_voxel_num"] = 100
        b = traffic.pool(tiny.tiny_mix(mix), cfg, 9)[0]
        sites, feats = R.voxelize(torch.as_tensor(b["points"]),
                                  torch.as_tensor(b["num_points"]), cfg)
        assert len(sites) == 200 and feats.shape == (200, b["points"]
                                                     .shape[-1])
