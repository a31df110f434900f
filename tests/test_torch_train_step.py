"""The train step: the port against the JAX package's, on the CPU.

``make_train_step`` on the small flagship (``small=True``) and on
configs/smoke_kitti_pointpillars.py as shipped, both fp32, from the same
weights and the same training scans (chip_smoke.py::train_scene: points in
rotated boxes, padded gt), 3 steps each side. Per step: the metric keys
equal to JAX's, the loss within LOSS_REL, every gradient (the port's
caught on its way to the optimizer, JAX's by ``jax.value_and_grad`` of
its step's loss, op by op) of the first step, at the weights both sides
share, within a relative L2 of GRAD_REL, the BatchNorm running
statistics within STATS_TOL after every step, and the parameters after
the first step where the gradient is clear of zero (Adam's first step
turns a gradient into its sign: where |g| is near zero the two sides'
rounding decides it, and the weights of later steps differ there). JAX's
gradients come from ``apply`` outside ``jax.jit``: under ``jax.jit`` XLA
reorders the reader's and first RPN block's fp32 sums, and its gradients
there move 2e-4 to 4e-4 (relative L2) from its own op-by-op ones, which
the port's meet within 1e-6 (the smoke config on the CPU).

configs/kitti_car_pointpillars.py (bf16 reader and neck) on a cut range,
widths as shipped: one step's loss and gradients against JAX's bf16 run
op by op (``apply`` outside ``jax.jit``, where the bf16 roundings are
those its code writes), the measured values printed; each bf16 layer's
gradients (the pillar net, RPN convs, the 0.5 branch, a transposed conv,
a head) in training mode against JAX's within BF16_LAYER_GRAD_REL. ``from_jax`` carries every parameter and every gradient of both
trained models (the flagship at full widths, KITTI car PointPillars).

``make_loss_eval_step`` against JAX's; ``init_state`` builds the shipped
optimizer and OneCycle schedule (the sparse middles' train steps:
tests/test_torch_sparse_train.py). The captured train step is held
to the eager one on the card in tests/test_torch_predict_graph.py, which
imports no JAX.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from __graft_entry__ import _build_flagship
from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.parallel.train import TrainState as JTrainState
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.parallel.train import make_loss_eval_step as jloss_step
from det3d_tpu.parallel.train import make_train_step as jtrain_step
from det3d_tpu.solver.optim import build_optimizer as jbuild_optimizer
from det3d_tpu.solver.schedules import build_lr_schedule as jbuild_lr
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import build_stack, init_state
from det3d_tpu_torch.parallel.train import (METRIC_KEYS, make_loss_eval_step,
                                            make_train_step)
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_modules import PC, SMALL, randomize
from tests.test_torch_pointpillars import _layer_pair, load

torch.set_num_threads(2)

LOSS_REL = 1e-5
GRAD_REL = 1e-4
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
CLEAR_OF_ZERO = 1e-4        # |g| / max|g| of a tensor: the sign is sure
# bf16 KITTI car, one step from the same weights, against JAX's bf16 op
# by op: the loss (measured 9e-4 relative) and every gradient. Training-
# mode BN's backward subtracts the cotangent's mean and its projection on
# the normalized input; in bf16 what is left is of the size of the
# roundings, so the gradients above the head are not reproducible between
# any two orders of summation: JAX's own jitted step lies 0.3-0.6
# (relative L2) from its op-by-op step in every RPN and reader tensor,
# the port 0.3-0.5 (measured on the CPU). The bound says the port is no
# further from JAX than JAX is from itself; the layer tests pin the
# rounding places.
BF16_LOSS_REL = 1e-2
BF16_STEP_REL = 0.75
BF16_LAYER_GRAD_REL = 1e-2     # measured at most 5.8e-3
BF16_ROUNDING = 2.0 ** -8
STEPS = 3
OPT_CFG = dict(optimizer=dict(TYPE="adam", VALUE=dict(amsgrad=0.0, wd=0.01),
                              FIXED_WD=True),
               lr_config=dict(type="one_cycle", lr_max=0.003,
                              moms=[0.95, 0.85], div_factor=10.0,
                              pct_start=0.4))
TOTAL_STEPS = 10
KITTI_CUT = [0.0, -6.4, -3.0, 12.8, 6.4, 1.0]
BF16_CUT = [0.0, -3.2, -3.0, 6.4, 3.2, 1.0]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_grads(model, params, stats, example, jit=True):
    """(loss, grads) of the JAX train step's loss at (params, stats)."""
    def loss_fn(p):
        preds, _ = model.apply(
            {"params": p, "batch_stats": stats}, example["voxels"],
            example["num_points_per_voxel"], example["coordinates"],
            train=True, mutable=["batch_stats"])
        return sum(model.loss(example, preds)["loss"])
    fn = jax.value_and_grad(loss_fn)
    return (jax.jit(fn) if jit else fn)(params)


class Pair:
    """One configuration on both sides, from the same weights: JAX's
    model, voxelizer, assigners, class ids and train state; the port's
    model, voxelizer, assigners, class ids and train state."""

    def __init__(self, cfg, jstack, var, scans):
        self.cfg, self.scans = cfg, scans
        self.jmodel, self.jvg, self.jasg, self.jcids = jstack
        self.var = var
        self.model, self.vg, self.asg, self.cids, _ = build_stack(
            cfg, device="cpu")
        self.model.load_state_dict(from_jax(var["params"],
                                            var["batch_stats"]))
        self.jbatch = {k: jnp.asarray(v) for k, v in scans.items()}

    def jax_state(self):
        lr_fn, mom_fn = jbuild_lr(self.cfg["lr_config"], TOTAL_STEPS)
        tx = jbuild_optimizer(self.cfg["optimizer"], lr_fn, mom_fn)
        return JTrainState.create(self.var["params"], self.var["batch_stats"],
                                  tx)

    def jax_example(self):
        return jax.jit(lambda b: jbuild_example(
            b, self.jvg, self.jasg, self.jcids))(self.jbatch)


def init_vars(model, vg, asg, cids, scans, seed):
    ex = jbuild_example({k: jnp.asarray(v) for k, v in scans.items()}, vg,
                        asg, cids, with_targets=False)
    init = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), ex["voxels"], ex["num_points_per_voxel"],
        ex["coordinates"], train=False)
    return randomize(init, seed)


@pytest.fixture(scope="module")
def flagship():
    jstack = _build_flagship(small=True, **SMALL)
    scans = cs.train_scene(2, 1500, PC, seed=1)
    cfg = dict(flagship_config(small=True, **SMALL), **OPT_CFG)
    return Pair(cfg, jstack, init_vars(*jstack, scans, 1), scans)


@pytest.fixture(scope="module")
def smoke():
    cfg = dict(load("smoke_kitti_pointpillars"), **OPT_CFG)
    jstack = jbuild_stack(copy.deepcopy(cfg))[:4]
    scans = cs.train_scene(2, 3000, cfg["voxel_generator"]["range"], seed=2)
    return Pair(cfg, jstack, init_vars(*jstack, scans, 2), scans)


def run_steps(pair):
    """STEPS steps on both sides: (JAX's gradients at the shared initial
    weights, op by op; per step (JAX metrics, port metrics, port grads,
    JAX's state after as the port's state dict, the port's); the
    parameter names)."""
    jstate = pair.jax_state()
    jstep = jtrain_step(pair.jmodel, pair.jvg, pair.jasg, pair.jcids)
    _, jg = jax_grads(pair.jmodel, jstate.params, jstate.batch_stats,
                      pair.jax_example(), jit=False)
    model = copy.deepcopy(pair.model)
    state, _ = init_state(pair.cfg, model, TOTAL_STEPS)
    seen = cs.spy_grads(state)
    step = make_train_step(state, pair.vg, pair.asg, pair.cids)
    out = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, pair.jbatch)     # donates its state
        tm = step(pair.scans)
        out.append((jm, tm, seen[-1],
                    from_jax(jax.tree.map(np.asarray, jstate.params),
                             jax.tree.map(np.asarray, jstate.batch_stats)),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return jg, out, [n for n, _ in model.named_parameters()]


@pytest.fixture(scope="module")
def flagship_run(flagship):
    return run_steps(flagship)


@pytest.fixture(scope="module")
def smoke_run(smoke):
    return run_steps(smoke)


RUNS = ["flagship_run", "smoke_run"]


@pytest.mark.parametrize("run", RUNS)
def test_metrics_equal_jax(run, request):
    for i, (jm, tm, *_) in enumerate(request.getfixturevalue(run)[1]):
        assert sorted(tm) == sorted(jm)
        assert {f"{k}_task0" for k in METRIC_KEYS} <= set(tm)
        for k in jm:
            ref, out = float(jm[k]), float(tm[k])
            if k.startswith(("num_pos", "num_neg", "num_voxels")):
                assert out == ref, (i, k)
            else:
                assert abs(out - ref) <= LOSS_REL * max(abs(ref), 1e-3), \
                    (i, k, out, ref)
        assert float(tm["num_pos_task0"]) > 0


@pytest.mark.parametrize("run", RUNS)
def test_gradients_equal_jax(run, request):
    """The first step's gradients, at the weights both sides share (later
    steps' weights differ where Adam turned a near-zero gradient's sign)."""
    jg, steps, names = request.getfixturevalue(run)
    ref = from_jax(jax.tree.map(np.asarray, jg), {})
    assert sorted(ref) == sorted(names)
    for name, g in zip(names, steps[0][2]):
        err = rel_l2(g.numpy(), ref[name].numpy())
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("run", RUNS)
def test_state_after_steps_equal_jax(run, request):
    """BN running statistics within STATS_TOL after every step; after the
    first step the parameters where the gradient is clear of zero."""
    jg, steps, names = request.getfixturevalue(run)
    for i, (_, _, _, ref, sd) in enumerate(steps):
        stats = [k for k in ref if k.endswith((".mean", ".var"))]
        assert stats
        for k in stats:
            torch.testing.assert_close(sd[k], ref[k], **STATS_TOL)
        if i:
            continue
        grads = from_jax(jax.tree.map(np.asarray, jg), {})
        for k in names:
            g = grads[k].abs()
            clear = g > CLEAR_OF_ZERO * float(g.max())
            assert float(clear.float().mean()) > 0.5, k
            torch.testing.assert_close(sd[k][clear], ref[k][clear],
                                       **PARAM_TOL)


def test_loss_eval_step_equals_jax(smoke):
    jstate = smoke.jax_state()
    ref = jax.jit(jloss_step(smoke.jmodel, smoke.jvg, smoke.jasg,
                             smoke.jcids))(jstate, smoke.jbatch)
    step = make_loss_eval_step(smoke.model, smoke.vg, smoke.asg, smoke.cids)
    before = {k: v.clone() for k, v in smoke.model.state_dict().items()}
    out = step(smoke.scans)
    assert sorted(out) == ["loss"]
    assert abs(float(out["loss"]) - float(ref["loss"])) <= LOSS_REL * abs(
        float(ref["loss"]))
    assert not smoke.model.training
    for k, v in smoke.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_bf16_kitti_car_step_close_to_jax(capsys):
    """configs/kitti_car_pointpillars.py in bf16 on a 6.4 x 6.4 m cut
    (widths as shipped), one step from the same weights: the loss within
    BF16_LOSS_REL of JAX's bf16 op by op, every gradient within a relative
    L2 of BF16_STEP_REL (printed: the worst tensor and the median)."""
    cfg = load("kitti_car_pointpillars")
    cfg["voxel_generator"].update(range=BF16_CUT, max_voxel_num=500)
    cfg["model"]["reader"]["pc_range"] = BF16_CUT
    for g in cfg["assigner"]["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = BF16_CUT[:2] + [z] + BF16_CUT[3:5] + [z]
    assert cfg["model"]["reader"]["precision"] == "bf16"
    cfg.update(OPT_CFG)
    jstack = jbuild_stack(copy.deepcopy(cfg))[:4]
    scans = cs.train_scene(2, 2000, BF16_CUT, n_gt=2, seed=3)
    pair = Pair(cfg, jstack, init_vars(*jstack, scans, 3), scans)
    loss, jg = jax_grads(pair.jmodel, pair.var["params"],
                         pair.var["batch_stats"], pair.jax_example(),
                         jit=False)
    state, _ = init_state(cfg, pair.model, TOTAL_STEPS)
    seen = cs.spy_grads(state)
    metrics = make_train_step(state, pair.vg, pair.asg, pair.cids)(scans)
    ref = from_jax(jax.tree.map(np.asarray, jg), {})
    names = [n for n, _ in pair.model.named_parameters()]
    assert sorted(ref) == sorted(names)
    errs = {n: rel_l2(g.numpy(), ref[n].numpy())
            for n, g in zip(names, seen[0])}
    worst = max(errs, key=errs.get)
    loss_err = abs(float(metrics["loss"]) - float(loss)) / abs(float(loss))
    with capsys.disabled():
        print(f"\nbf16 KITTI car step: loss rel err {loss_err:.2e}; gradient "
              f"rel L2 worst {errs[worst]:.2e} ({worst}), median "
              f"{np.median(list(errs.values())):.2e}")
    assert loss_err <= BF16_LOSS_REL
    assert errs[worst] <= BF16_STEP_REL, (worst, errs[worst])


@pytest.mark.parametrize("layer", ["pfn", "rpn_conv", "branch_half",
                                   "deconv", "head"])
def test_bf16_layer_gradients_close_to_jax(layer):
    """One bf16 layer in training mode (BN on batch statistics), the same
    inputs, weights and output cotangent on both sides: every parameter's
    gradient within BF16_LAYER_GRAD_REL of JAX's op by op. The rounding
    places of the backward are pinned here, layer by layer; through the
    whole network they cannot be (see test_bf16_kitti_car_step_close_to_
    jax)."""
    jl, jargs, port, targs = _layer_pair(layer, np.random.RandomState(0))
    var = randomize({"batch_stats": {},
                     **jl.init(jax.random.PRNGKey(0), *jargs)}, 1)
    kw = {} if layer == "head" else {"train": True}

    def flat(out):
        if isinstance(out, dict):
            return jnp.concatenate([out[k].astype(jnp.float32) for k in
                                    ("box_preds", "cls_preds")], -1)
        return out.astype(jnp.float32)

    shape = flat(jl.apply(var, *jargs)).shape
    cot = np.random.RandomState(1).normal(0, 1, shape).astype(np.float32)

    def jloss(params):
        out = jl.apply({"params": params,
                        "batch_stats": var["batch_stats"]}, *jargs,
                       mutable=["batch_stats"], **kw)[0]
        return jnp.sum(flat(out) * cot)

    jg = jax.grad(jloss)(var["params"])
    name = "neck" if layer not in ("pfn", "head") else "m"
    sd = from_jax({name: var["params"]}, {name: var["batch_stats"]})
    port.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()})
    port.train()
    out = port(*targs)
    if layer == "head":
        out = torch.cat([out["box_preds"], out["cls_preds"]], -1)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    ref = from_jax({name: jax.tree.map(np.asarray, jg)}, {})
    for k, p in port.named_parameters():
        if layer == "head" and k.endswith(".bias"):
            continue
        err = rel_l2(p.grad.numpy(), ref[f"{name}.{k}"].numpy())
        assert err <= BF16_LAYER_GRAD_REL, (k, err)
    if layer == "head":
        # a bf16 bias's gradient is the sum of the bf16 cotangents over
        # B x H x W: the port sums in fp32 and rounds once to bf16, within
        # one bf16 rounding of the exact sum; JAX sums in bf16 (1.3e-2
        # from the exact sum on the box bias here)
        c = torch.from_numpy(cot).bfloat16().double().sum((0, 1, 2))
        n_box = port.conv_box.out_channels
        for conv, exact in ((port.conv_box, c[:n_box]),
                            (port.conv_cls, c[n_box:])):
            err = rel_l2(conv.bias.grad.double().numpy(), exact.numpy())
            assert err <= BF16_ROUNDING, err


def test_from_jax_covers_every_parameter_and_gradient():
    """Both trained models at their widths (the flagship as shipped and
    KITTI car PointPillars, each on a cut range): from_jax maps JAX's
    parameters, statistics and gradients (their trees and shapes, from
    ``jax.eval_shape`` of ``init`` and of the step's ``value_and_grad``)
    onto every tensor the port's model has, at its shape."""
    flag = (_build_flagship(small=False, **SMALL),
            flagship_config(small=False, **SMALL))
    kcfg = load("kitti_car_pointpillars")
    kcfg["voxel_generator"].update(range=KITTI_CUT, max_voxel_num=300)
    kcfg["model"]["reader"]["pc_range"] = KITTI_CUT
    kitti = (jbuild_stack(copy.deepcopy(kcfg))[:4], kcfg)
    scans = cs.train_scene(1, 600, KITTI_CUT, n_gt=2, seed=4)

    def zeros(tree):
        return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)

    for jstack, cfg in (flag, kitti):
        ex = jax.jit(lambda b: jbuild_example(b, *jstack[1:]))(
            {k: jnp.asarray(v) for k, v in scans.items()})
        var = zeros(jax.eval_shape(
            lambda e: jstack[0].init(jax.random.PRNGKey(0), e["voxels"],
                                     e["num_points_per_voxel"],
                                     e["coordinates"], train=False), ex))
        grads = zeros(jax.eval_shape(
            lambda p: jax_grads(jstack[0], p, var["batch_stats"], ex,
                                jit=False)[1], var["params"]))
        model = build_stack(cfg, device="cpu")[0]
        sd = model.state_dict()
        carried = from_jax(var["params"], var["batch_stats"])
        assert sorted(carried) == sorted(sd)
        g = from_jax(grads, {})
        params = dict(model.named_parameters())
        assert sorted(g) == sorted(params)
        for k, p in params.items():
            assert g[k].shape == p.shape and carried[k].shape == p.shape, k


def test_init_state_as_shipped():
    """kitti_car_pointpillars.py's optimizer: Adam, wd 0.01 on every
    non-BN parameter, the OneCycle lr (0.0003 at step 0) and b1 (0.95),
    clipping at 35; the step count starts at 0 on the model's device."""
    cfg = load("smoke_kitti_pointpillars")
    full = dict(cfg, optimizer=OPT_CFG["optimizer"],
                lr_config=OPT_CFG["lr_config"])
    model = build_stack(cfg, device="cpu")[0]
    state, lr_fn = init_state(full, model, 100)
    tx = state.tx
    assert tx.kind == "adam" and tx.weight_decay == 0.01
    assert tx.grad_clip_norm == 35.0 and int(state.step) == 0
    lr, b1 = tx.hyperparams()
    assert float(lr) == pytest.approx(3e-4) and float(b1) == pytest.approx(
        0.95)
    assert float(lr_fn(torch.tensor(40))) == pytest.approx(3e-3)
    n_bn = sum(n.endswith(("norm.scale", "norm.bias", "_bn.scale",
                           "_bn.bias")) for n in tx.names)
    assert n_bn > 0 and sum(not d for d in tx.decay) == n_bn
