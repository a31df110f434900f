"""The sparse middles' training plans and the window conv's backward: the
port against the JAX package, on the CPU.

- Training plans (``train=True``: each strided conv's packed inverse
  rulebook ``inv{i}`` beside the evaluation keys): the port's native host
  build (``host_plan_fn``), its numpy build (``host_plan_ref_fn``), JAX's
  host build, the port's ``build_plan_device`` from its device voxels and
  JAX's ``build_plan_device(train=True)`` are equal array for array, on
  cut SECOND (dense tail from stage 3, and without a tail: the sparse z
  conv's (2, 1, 1) candidates) and CBGS (dense from stage 2) scans, one
  overflowing the voxel cap and one padded.
- The conv: ``window_conv``'s dX and dW (autograd over the plain twins:
  ``window_conv_subm_dx`` for a subm conv, ``window_conv_inv`` over the
  inverse rulebook for a strided one, ``window_conv_dw`` for both, with
  and without ``center_shift``) against ``jax.vjp`` of
  ``apply_conv_window`` / ``apply_conv_window_inv`` at Cin 4, 16 and 64
  and Cout 16 and 64, fp32, on a padded training plan: within CONV_REL
  relative L2 (measured at most 4e-7: sums in another order).
- ``torch.autograd.gradcheck`` of the Function in float64 on a tiny plan
  (subm, strided, the z conv): the twins are the exact adjoint of the
  forward, padded rows included.
- Training-mode BN: ``SparseConvBN`` with its valid-row mask and
  ``DenseConvBN`` with its occupancy against JAX's layers with
  ``train=True``: outputs, gradients and running statistics.
- A middle built with ``serve_precision="bf16"`` trains in ``precision``
  (fp32) from a host plan, as JAX's (``serving = plan is not None and not
  train``): its training forward and gradients equal JAX's fp32 ones.

Card-only tests of the kernels are in tests/test_torch_kernels_cuda.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu.models import backbones as jbb
from det3d_tpu.ops import sparse as jsp
from det3d_tpu_torch.apis.train import (build_stack, host_plan_fn,
                                        host_plan_ref_fn)
from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.ops import sparse as sp
from det3d_tpu_torch.ops.window_conv_cuda import window_conv
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_modules import randomize

torch.set_num_threads(2)

CONV_REL = 1e-5
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MIDDLE_REL = 1e-5
CUT = (6.4, 512)
SHAPE = (41, 24, 20)            # a small grid at SECOND's depth


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check_param_grads(params, grads, ref):
    """Each parameter's gradient within CONV_REL of JAX's, but the conv
    bias before a training-mode BN, whose gradient is zero in exact
    arithmetic (the BN takes out the batch mean): both sides' must be
    rounding-sized, below 1e-4 of the weight gradient's norm."""
    w = dict(zip(params, grads))["weight"].norm()
    for n, g in zip(params, grads):
        if n == "bias":
            assert float(g.norm()) <= 1e-4 * float(w), n
            assert float(ref[n].norm()) <= 1e-4 * float(w), n
        else:
            assert rel_l2(g.numpy(), ref[n].numpy()) <= CONV_REL, n


def layer_sd(name, params, stats):
    """from_jax of one layer's variables: (state dict, gradient map) keys
    without the layer's name."""
    sd = from_jax({name: params}, {name: stats})
    return {k[len(name) + 1:]: v for k, v in sd.items()}


def cut_config(path, **backbone):
    cfg = cs.sparse_config(path, cut=CUT)
    cfg["model"]["backbone"].update(backbone)
    return cfg


CONFIGS = {"second": (cs.SECOND_CFG, {}),
           "second_no_tail": (cs.SECOND_CFG, {"dense_tail": False}),
           "cbgs": (cs.CBGS_CFG, {})}


def scans(key):
    """Two scans on the cut range: the first overflows the 512-voxel cap,
    the second leaves rows padded."""
    cfg = cut_config(CONFIGS[key][0])
    s = cs.sparse_train_scene("cbgs" if key == "cbgs" else "second", 2,
                              cfg["voxel_generator"]["range"], 3000, seed=5)
    s["num_points"][1] = 150
    return s


# ---------------------------------------------------------------------------
# training plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", sorted(CONFIGS))
def test_training_plans_equal_jax(key):
    path, bbk = CONFIGS[key]
    cfg = cut_config(path, **bbk)
    s = scans(key)
    model, vg = build_stack(cfg, device="cpu")[:2]
    host = host_plan_fn(model, vg, train=True)(s["points"], s["num_points"])
    ref = host_plan_ref_fn(model, vg, train=True)(s["points"],
                                                  s["num_points"])
    jm, jvg = jbuild_stack(copy.deepcopy(cfg))[:2]
    jhost = jhost_plan_fn(jm, jvg, train=True)(s["points"], s["num_points"])
    assert sorted(host) == sorted(ref) == sorted(jhost)
    stages = len(bb.middle_plan_spec(model.backbone, vg.grid_size,
                                     vg.max_voxels)["stages"])
    assert {f"plan_inv{i}" for i in range(1, stages + 1)} <= set(host)
    for k in host:
        assert host[k].dtype == np.int32, k
        np.testing.assert_array_equal(host[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(host[k], np.asarray(jhost[k]),
                                      err_msg=k)
    vox = vg.generate_batch(torch.from_numpy(s["points"]),
                            torch.from_numpy(s["num_points"]))
    assert int(vox["num_voxels"][1]) < vg.max_voxels      # padded rows
    spec = bb.middle_plan_spec(model.backbone, vg.grid_size, vg.max_voxels)
    dev = bb.build_plan_device(vox["coords"], spec, train=True)
    assert sorted(dev) == sorted(k[5:] for k in host if k.startswith("plan_"))
    jdev = jax.jit(lambda c: jbb.build_plan_device(c, spec, True))(
        jnp.asarray(vox["coords"].numpy()))
    for k, v in dev.items():
        assert v.dtype == torch.int32, k
        np.testing.assert_array_equal(v.numpy(), host[f"plan_{k}"],
                                      err_msg=k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdev[k]),
                                      err_msg=k)


def test_evaluation_plans_have_no_inverse():
    cfg = cut_config(cs.SECOND_CFG)
    s = scans("second")
    model, vg = build_stack(cfg, device="cpu")[:2]
    host = host_plan_fn(model, vg)(s["points"], s["num_points"])
    assert not any(k.startswith("plan_inv") for k in host)
    spec = bb.middle_plan_spec(model.backbone, vg.grid_size, vg.max_voxels)
    vox = vg.generate_batch(torch.from_numpy(s["points"]),
                            torch.from_numpy(s["num_points"]))
    assert not any(k.startswith("inv")
                   for k in bb.build_plan_device(vox["coords"], spec))


# ---------------------------------------------------------------------------
# the conv's backward against JAX's custom VJPs
# ---------------------------------------------------------------------------

def small_plan(seed=0, b=2, v=96, n=(140, 50)):
    """A training plan of seeded voxel sets on SHAPE (the second set leaves
    rows padded), through build_plan_device, and its res0 coords."""
    rng = np.random.RandomState(seed)
    co = np.full((b, v, 3), -1, np.int32)
    for i in range(b):
        lin = np.unique(rng.randint(0, np.prod(SHAPE), n[i]))[:v]
        h, w = SHAPE[1:]
        co[i, :len(lin)] = np.stack([lin // (h * w), (lin // w) % h,
                                     lin % w], 1)
    spec = bb.middle_plan_spec(dict(dense_tail=False),
                               (SHAPE[2], SHAPE[1], SHAPE[0] - 1), v)
    return bb.build_plan_device(torch.from_numpy(co), spec, train=True)


@pytest.fixture(scope="module")
def plan():
    return small_plan()


def port_grads(x, packed, w, center_shift, inverse, dy):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = window_conv(xt, packed, wt, center_shift, inverse)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(dy))
    return out.detach().numpy(), dx.numpy(), dw.numpy()


@pytest.mark.parametrize("cin", [4, 16, 64])
@pytest.mark.parametrize("cout", [16, 64])
@pytest.mark.parametrize("kind", ["subm", "strided", "z"])
def test_conv_backward_equals_jax_vjp(plan, cin, cout, kind):
    rng = np.random.RandomState(cin + cout)
    if kind == "subm":
        packed, kz, inverse, rows = plan["s0"], 3, None, plan["s0"].shape[1]
    elif kind == "strided":
        packed, rows = plan["down1"], plan["s0"].shape[1]
        inverse = (plan["inv1"], (3, 3, 3), (2, 2, 2))
    else:
        packed, rows = plan["down4"], plan["co3"].shape[1]
        inverse = (plan["inv4"], (3, 1, 1), (2, 1, 1))
    b, o, k = packed.shape
    x = rng.randn(b, rows, cin).astype(np.float32)
    w = (rng.randn(3 * k, cin, cout) / np.sqrt(3 * k * cin)).astype(
        np.float32)
    dy = rng.randn(b, o, cout).astype(np.float32)
    out, dx, dw = port_grads(x, packed, w, kind == "subm", inverse, dy)
    r0, pres = (jnp.asarray(a.numpy()) for a in sp.unpack_windows(packed, 3))
    if kind == "subm":
        fn = lambda f, ww: jsp.apply_conv_window(f, r0, pres, ww, True)
    else:
        kspec = (inverse[1], inverse[2], sp.ncand_of(*inverse[1:]))
        r0i, presi, par, kspec = jsp.unpack_inverse(
            jnp.asarray(inverse[0].numpy()), kspec)
        fn = lambda f, ww: jsp.apply_conv_window_inv(
            f, r0, pres, ww, r0i, presi, par, kspec)
    jout, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    for name, a, r in (("out", out, jout), ("dX", dx, jdx), ("dW", dw, jdw)):
        err = rel_l2(a, r)
        assert err <= CONV_REL, (name, err)


@pytest.mark.parametrize("center_shift", [True, False])
def test_dw_with_and_without_center_shift_equals_jax(plan, center_shift):
    """dW of a subm rulebook whose center column runs by rank shifts or
    through the window gather: the same function, each against JAX's
    _window_conv_dw."""
    from det3d_tpu_torch.ops.window_conv_cuda import window_conv_dw
    rng = np.random.RandomState(7)
    packed = plan["s0"]
    x = rng.randn(2, packed.shape[1], 16).astype(np.float32)
    dy = rng.randn(2, packed.shape[1], 32).astype(np.float32)
    dw = window_conv_dw(torch.from_numpy(x), packed, torch.from_numpy(dy),
                        center_shift)
    r0, pres = (jnp.asarray(a.numpy()) for a in sp.unpack_windows(packed, 3))
    ref = jsp._window_conv_dw(jnp.asarray(x), r0, pres, jnp.asarray(dy),
                              center_shift)
    assert rel_l2(dw.numpy(), ref) <= CONV_REL


def test_strided_conv_without_inverse_raises_in_backward(plan):
    """A strided conv without its inverse rulebook no longer raises in its
    backward: its dX is the flat per-tap scatter-add (window_to_flat,
    flat_conv_dx), equal to the inverse rulebook's dX on the same conv."""
    torch.manual_seed(0)
    x = torch.randn(2, plan["s0"].shape[1], 4, requires_grad=True)
    w = torch.randn(27, 4, 16)
    out = window_conv(x, plan["down1"], w, False)
    out.sum().backward()
    inverse = (plan["inv1"], (3, 3, 3), (2, 2, 2))
    x2 = x.detach().clone().requires_grad_(True)
    window_conv(x2, plan["down1"], w, False, inverse).sum().backward()
    assert rel_l2(x.grad.numpy(), x2.grad.numpy()) <= CONV_REL
    assert x.grad.abs().sum() > 0


def test_stem_input_gets_no_dx(plan, monkeypatch):
    """Features that need no gradient (the stem's VFE means) take no dX:
    only dW runs."""
    from det3d_tpu_torch.ops import window_conv_cuda as wc
    called = []
    monkeypatch.setattr(wc, "window_conv_subm_dx",
                        lambda *a: called.append(1))
    x = torch.randn(2, plan["s0"].shape[1], 4)
    w = torch.randn(27, 4, 16, requires_grad=True)
    window_conv(x, plan["s0"], w, True).sum().backward()
    assert not called and w.grad is not None


@pytest.mark.parametrize("kind", ["subm", "strided", "z"])
def test_function_gradcheck_float64(kind):
    """The CPU path's backward (the twins) is the adjoint of its forward,
    padded rows included: gradcheck in float64 on a tiny plan."""
    tiny = small_plan(seed=1, v=24, n=(30, 12))
    if kind == "subm":
        packed, rows, cs_, inv = tiny["s0"], 24, True, None
    elif kind == "strided":
        packed, rows, cs_ = tiny["down1"], 24, False
        inv = (tiny["inv1"], (3, 3, 3), (2, 2, 2))
    else:
        packed, rows, cs_ = tiny["down4"], tiny["co3"].shape[1], False
        inv = (tiny["inv4"], (3, 1, 1), (2, 1, 1))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, rows, 2, dtype=torch.float64, generator=g,
                    requires_grad=True)
    w = torch.randn(3 * packed.shape[-1], 2, 3, dtype=torch.float64,
                    generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, c: window_conv(a, packed, c, cs_, inv), (x, w))


# ---------------------------------------------------------------------------
# training-mode BN of the layers
# ---------------------------------------------------------------------------

def test_sparse_conv_bn_masks_its_batch_statistics():
    """A strided SparseConvBN in training: outputs, dX and dW and the
    running statistics equal JAX's with its valid mask; statistics over
    every row would differ (the padded rows' outputs are the bias)."""
    plan = small_plan(seed=2, n=(60, 20))
    rng = np.random.RandomState(3)
    x = rng.randn(2, plan["s0"].shape[1], 16).astype(np.float32)
    co = sp.delinearize(plan["co1"], (21, 12, 10))
    valid = (co[..., 0] >= 0).numpy()
    assert not valid.all()
    r0, pres = (jnp.asarray(a.numpy())
                for a in sp.unpack_windows(plan["down1"], 3))
    kspec = ((3, 3, 3), (2, 2, 2), (2, 2, 2))
    jinv = jsp.unpack_inverse(jnp.asarray(plan["inv1"].numpy()), kspec)
    jl = jbb.SparseConvBN(32, {"type": "BN"}, use_bias=True)
    var = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x), r0, pres,
                            jnp.asarray(valid)), 3)
    ct = rng.randn(2, plan["down1"].shape[1], 32).astype(np.float32)

    def jfn(p, f):
        y, st = jl.apply({"params": p, "batch_stats": var["batch_stats"]},
                         f, r0, pres, jnp.asarray(valid), True,
                         inverse=jinv, mutable=["batch_stats"])
        return y, st

    jy, vjp, jst = jax.vjp(jfn, var["params"], jnp.asarray(x), has_aux=True)
    jgp, jgx = vjp(jnp.asarray(ct))

    layer = bb.SparseConvBN(16, 32, {"type": "BN"}, use_bias=True)
    layer.load_state_dict(layer_sd("SparseConvBN_0", var["params"],
                                   var["batch_stats"]))
    layer.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt, plan["down1"], False, None, co[..., 0] >= 0,
              (plan["inv1"], (3, 3, 3), (2, 2, 2)))
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(y, [xt] + list(params.values()),
                                torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), jy, **LAYER_TOL)
    assert rel_l2(grads[0].numpy(), jgx) <= CONV_REL
    check_param_grads(params, grads[1:], layer_sd(
        "SparseConvBN_0", jax.tree.map(np.asarray, jgp), {}))
    jstats = layer_sd("SparseConvBN_0", var["params"], jax.tree.map(
        np.asarray, jst["batch_stats"]))
    for k in ("norm.mean", "norm.var"):
        torch.testing.assert_close(layer.state_dict()[k], jstats[k],
                                   **LAYER_TOL)
    with torch.no_grad():
        unmasked = layer.norm.batch_stats(
            window_conv(torch.from_numpy(x), plan["down1"], layer.weight,
                        False) + layer.bias)[0]
    assert not torch.allclose(unmasked, layer.norm.batch_stats(
        window_conv(torch.from_numpy(x), plan["down1"], layer.weight, False)
        + layer.bias, co[..., 0] >= 0)[0], atol=1e-3)


def test_dense_conv_bn_masks_its_batch_statistics():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 3, 6, 5, 8).astype(np.float32)
    occ = rng.rand(2, 3, 6, 5) < 0.3
    x = x * occ[..., None]
    jl = jbb.DenseConvBN(16, norm_cfg={"type": "BN"}, use_bias=True)
    var = randomize(jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(occ)), 4)
    ct = rng.randn(2, 3, 6, 5, 16).astype(np.float32)
    jy, vjp, jst = jax.vjp(
        lambda p, f: jl.apply({"params": p,
                               "batch_stats": var["batch_stats"]}, f,
                              jnp.asarray(occ), True,
                              mutable=["batch_stats"]),
        var["params"], jnp.asarray(x), has_aux=True)
    jgp, jgx = vjp(jnp.asarray(ct))
    layer = bb.DenseConvBN(8, 16, norm_cfg={"type": "BN"}, use_bias=True)
    layer.load_state_dict(layer_sd("DenseConvBN_0", var["params"],
                                   var["batch_stats"]))
    layer.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layer(xt, torch.from_numpy(occ))
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(y, [xt] + list(params.values()),
                                torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), jy, **LAYER_TOL)
    assert rel_l2(grads[0].numpy(), jgx) <= CONV_REL
    check_param_grads(params, grads[1:], layer_sd(
        "DenseConvBN_0", jax.tree.map(np.asarray, jgp), {}))
    jstats = layer_sd("DenseConvBN_0", var["params"], jax.tree.map(
        np.asarray, jst["batch_stats"]))
    for k in ("norm.mean", "norm.var"):
        torch.testing.assert_close(layer.state_dict()[k], jstats[k],
                                   **LAYER_TOL)


# ---------------------------------------------------------------------------
# a bf16-serving middle trains in fp32
# ---------------------------------------------------------------------------

def test_bf16_serving_middle_trains_in_fp32():
    cfg = cut_config(cs.SECOND_CFG, serve_precision="bf16")
    s = scans("second")
    jm, jvg, jasg, jcids, _ = jbuild_stack(copy.deepcopy(cfg))
    plan = jhost_plan_fn(jm, jvg, train=True, voxelize=True)(
        s["points"], s["num_points"])
    coords = jnp.asarray(plan["coordinates"])
    feats = np.random.RandomState(6).randn(
        *plan["coordinates"].shape[:2], 4).astype(np.float32)
    jplan = {k[5:]: jnp.asarray(v) for k, v in plan.items()
             if k.startswith("plan_")}
    gs = tuple(jvg.grid_size)
    init = jax.jit(lambda f: jm.backbone.init(
        jax.random.PRNGKey(0), f, coords, gs, train=False))(
            jnp.asarray(feats))
    var = randomize(init, 6)
    out, vjp = jax.vjp(lambda p: jm.backbone.apply(
        {"params": p, "batch_stats": var["batch_stats"]}, jnp.asarray(feats),
        coords, gs, train=True, plan=jplan, mutable=["batch_stats"])[0],
        var["params"])
    ct = np.random.RandomState(7).randn(*out.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))

    middle = build_stack(cfg, device="cpu")[0].backbone
    middle.load_state_dict(from_jax(var["params"], var["batch_stats"]))
    assert middle.SparseConvBN_1.dtype == torch.bfloat16   # serves bf16
    middle.train()
    tplan = {k[5:]: torch.from_numpy(v) for k, v in plan.items()
             if k.startswith("plan_")}
    y = middle(torch.from_numpy(feats), torch.from_numpy(
        plan["coordinates"]), gs, plan=tplan)
    assert y.dtype == torch.float32
    assert rel_l2(y.detach().numpy(), out) <= MIDDLE_REL
    params = dict(middle.named_parameters())
    grads = torch.autograd.grad(y, list(params.values()),
                                torch.from_numpy(ct))
    ref = from_jax(jax.tree.map(np.asarray, jg), {})
    for (n, _), g in zip(params.items(), grads):
        if n.endswith(".bias") and ".norm." not in n:
            continue            # before a training BN: zero but rounding
        assert rel_l2(g.numpy(), ref[n].numpy()) <= MIDDLE_REL, n
