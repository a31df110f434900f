"""The sparse middles' train step: the port against the JAX package, on
the CPU, for SECOND (tests/test_torch_sparse_train_cbgs.py does CBGS with
the same checks).

configs/kitti_car_second.py as shipped, cut to +-6.4 m and 512 voxels
(``chip_smoke.py::sparse_config(..., cut=(6.4, 512))``, every width as
shipped), from the same random weights and training scans
(``chip_smoke.py::sparse_train_scene``), STEPS steps each side: fed host
training plans (``host_plan_fn(train=True, voxelize=True)``, equal to
JAX's), and fed points alone (each side voxelizes and builds its training
plan on the device).

- The first step: the metric keys equal JAX's, the losses within
  LOSS_REL (measured 2.4e-6), counts equal, ``grad_norm`` within
  STEP_GRAD_REL (measured 2.9e-4).
- The first step's gradients, at the weights both sides share, against
  JAX's op by op (``apply`` outside ``jax.jit``): the head's within
  HEAD_GRAD_REL relative L2 (measured 3.0e-5), every other one within
  STEP_GRAD_REL (measured up to 1.05e-2 on a norm bias, median 3e-3;
  CBGS 6.9e-3 and 5e-3). Below the head the RPN's and the middle's
  training BN backward amplify any change of rounding: JAX's fp32 RPN
  output on this map lies 3.5e-5 (relative L2) from a float64
  evaluation, the port's 1.4e-6 (XLA:CPU's sequential fp32 reductions
  in the training BN's E[x²] - mean²;
  ``jax.default_matmul_precision("highest")`` changes nothing), and on
  the H100 cuDNN off against on moves these gradients up to 1.6e-2
  (chip_smoke.py::SPARSE_GRAD_REL). So the middle is also held alone,
  on the same inputs and cotangent, within MIDDLE_GRAD_REL (measured
  2e-6).
- BatchNorm running statistics after the first step within STATS_TOL;
  the parameters after it where both gradients are clear of zero and of
  one sign (Adam's first step is the gradient's sign). The second step
  starts from weights that differ where a near-zero gradient's sign
  flipped, by twice the learning rate: its losses are held within
  LATER_REL (measured 3.9e-4, CBGS 2.6e-3).
- ``make_loss_eval_step`` from host plans equals JAX's.
- ``from_jax`` maps every parameter and gradient of both middles.
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
from det3d_tpu.parallel.train import TrainState as JTrainState
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.parallel.train import make_loss_eval_step as jloss_step
from det3d_tpu.parallel.train import make_train_step as jtrain_step
from det3d_tpu.solver.optim import build_optimizer as jbuild_optimizer
from det3d_tpu.solver.schedules import build_lr_schedule as jbuild_lr
from det3d_tpu_torch.apis.train import build_stack, init_state
from det3d_tpu_torch.parallel.train import (METRIC_KEYS, make_loss_eval_step,
                                            make_train_step)
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_modules import randomize

torch.set_num_threads(2)

LOSS_REL = 1e-5
LATER_REL = 1e-2
HEAD_GRAD_REL = 1e-4
STEP_GRAD_REL = 3e-2
MIDDLE_GRAD_REL = 1e-5
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
CLEAR_OF_ZERO = 1e-2     # of the tensor's largest: above the gradients' spread
CLEAR_ABS = 1e-5            # 1000 x Adam's eps: its first step is the sign
STEPS = 2
TOTAL_STEPS = 10
CUT = (6.4, 512)
PATHS = {"second": cs.SECOND_CFG, "cbgs": cs.CBGS_CFG}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class SparsePair:
    """A cut sparse config on both sides from the same weights: JAX's
    stack and variables, the port's stack, and the scans with JAX's host
    training plan and voxels."""

    def __init__(self, key, seed):
        self.key = key
        self.cfg = cs.sparse_config(PATHS[key], cut=CUT)
        (self.jmodel, self.jvg, self.jasg, self.jcids,
         _) = jbuild_stack(copy.deepcopy(self.cfg))
        self.scans = cs.sparse_train_scene(
            key, 2, self.cfg["voxel_generator"]["range"], 3000, seed=seed)
        plan = jhost_plan_fn(self.jmodel, self.jvg, train=True,
                             voxelize=True)(self.scans["points"],
                                            self.scans["num_points"])
        self.batch = dict(self.scans,
                          **{k: np.asarray(v) for k, v in plan.items()})
        ex = jbuild_example({k: jnp.asarray(v) for k, v in
                             self.batch.items()}, self.jvg, self.jasg,
                            self.jcids, with_targets=False)
        init = jax.jit(self.jmodel.init, static_argnames=("train",))(
            jax.random.PRNGKey(0), ex["voxels"], ex["num_points_per_voxel"],
            ex["coordinates"], train=False)
        self.var = randomize(init, seed)

    def port_model(self):
        model, vg, asg, cids, _ = build_stack(self.cfg, device="cpu")
        model.load_state_dict(from_jax(self.var["params"],
                                       self.var["batch_stats"]))
        return model, vg, asg, cids

    def jax_state(self):
        lr_fn, mom_fn = jbuild_lr(self.cfg["lr_config"], TOTAL_STEPS)
        tx = jbuild_optimizer(self.cfg["optimizer"], lr_fn, mom_fn)
        return JTrainState.create(self.var["params"],
                                  self.var["batch_stats"], tx)

    def jax_grads(self, batch):
        """JAX's loss gradients at the shared weights, op by op (``apply``
        outside ``jax.jit``)."""
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        plan = {k[5:]: v for k, v in jb.items() if k.startswith("plan_")}
        kw = {"plan": plan} if plan else {}
        jm, stats = self.jmodel, self.var["batch_stats"]

        def loss_fn(p, b):
            ex = jbuild_example(b, self.jvg, self.jasg, self.jcids,
                                with_targets=True)
            preds, _ = jm.apply({"params": p, "batch_stats": stats},
                                ex["voxels"], ex["num_points_per_voxel"],
                                ex["coordinates"], train=True,
                                mutable=["batch_stats"], **kw)
            return sum(jm.loss(ex, preds)["loss"])
        return jax.grad(loss_fn)(self.var["params"], jb)


def run_steps(pair, batch):
    """STEPS steps on both sides from ``batch``: (JAX's first-step
    gradients as the port's names, per step (JAX metrics, port metrics,
    port grads, JAX's state as a state dict, the port's), the parameter
    names)."""
    jstate = pair.jax_state()
    jstep = jtrain_step(pair.jmodel, pair.jvg, pair.jasg, pair.jcids)
    jg = from_jax(jax.tree.map(np.asarray, pair.jax_grads(batch)), {})
    model, vg, asg, cids = pair.port_model()
    state, _ = init_state(pair.cfg, model, TOTAL_STEPS)
    seen = cs.spy_grads(state)
    step = make_train_step(state, vg, asg, cids)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        tm = step(batch)
        out.append((jm, tm, seen[-1],
                    from_jax(jax.tree.map(np.asarray, jstate.params),
                             jax.tree.map(np.asarray, jstate.batch_stats)),
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return jg, out, [n for n, _ in model.named_parameters()]


def check_metrics(run):
    for i, (jm, tm, *_) in enumerate(run[1]):
        assert sorted(tm) == sorted(jm)
        assert {f"{k}_task0" for k in METRIC_KEYS} <= set(tm)
        for k in jm:
            ref, out = float(jm[k]), float(tm[k])
            tol = (LATER_REL if i else
                   STEP_GRAD_REL if k == "grad_norm" else LOSS_REL)
            if k.startswith(("num_pos", "num_neg", "num_voxels")):
                assert out == ref, (i, k)
            else:
                assert abs(out - ref) <= tol * max(abs(ref), 1e-3), \
                    (i, k, out, ref)
        assert float(tm["num_pos_task0"]) > 0


def check_gradients(run):
    """The first step's gradients within STEP_GRAD_REL of JAX's; the conv
    biases before a training BN below 1e-4 of their weight gradient."""
    jg, steps, names = run
    assert sorted(jg) == sorted(names)
    grads = dict(zip(names, steps[0][2]))
    for name, g in grads.items():
        if name in cs.zero_grad_bias(names):
            w = grads[name.rsplit(".", 1)[0] + ".weight"].norm()
            assert float(g.norm()) <= 1e-4 * float(w), name
            continue
        err = rel_l2(g.numpy(), jg[name].numpy())
        tol = HEAD_GRAD_REL if name.startswith("bbox_head") else \
            STEP_GRAD_REL
        assert err <= tol, (name, err)


def check_state(run):
    """BN running statistics after every step; the parameters after the
    first step where both sides' gradients are clear of zero (CLEAR_OF_ZERO
    of the tensor's largest) and of one sign: Adam's first step is the
    gradient's sign."""
    jg, steps, names = run
    port = dict(zip(names, steps[0][2]))
    for i, (_, _, _, ref, sd) in enumerate(steps[:1]):
        stats = [k for k in ref if k.endswith((".mean", ".var"))]
        assert any(k.startswith("backbone.") for k in stats)
        for k in stats:
            torch.testing.assert_close(sd[k], ref[k], **STATS_TOL)
        for k in names:
            if k in cs.zero_grad_bias(names):
                continue
            a, b = jg[k], port[k]
            clear = ((a.abs() > CLEAR_OF_ZERO * float(a.abs().max()))
                     & (b.abs() > CLEAR_OF_ZERO * float(b.abs().max()))
                     & (a.abs() > CLEAR_ABS) & (b.abs() > CLEAR_ABS)
                     & (torch.sign(a) == torch.sign(b)))
            torch.testing.assert_close(sd[k][clear], ref[k][clear],
                                       **PARAM_TOL)


def check_middle(pair, host):
    """The middle alone in training mode on the example's voxel features
    and a random cotangent: output and every gradient within
    MIDDLE_GRAD_REL of JAX's VJP (op by op), from the host plan or from
    the plan each side builds on the device."""
    jb = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    ex = jbuild_example(jb, pair.jvg, pair.jasg, pair.jcids)
    rng = np.random.RandomState(9)
    feats = (rng.rand(*ex["voxels"].shape).astype(np.float32)
             * np.asarray(ex["num_voxels"] > 0, np.float32)[:, None, None])
    plan = {k[5:]: v for k, v in jb.items() if k.startswith("plan_")}
    kw = {"plan": plan} if host else {}
    gs = tuple(pair.jvg.grid_size)
    coords = ex["coordinates"]
    bvars = {"params": pair.var["params"]["backbone"],
             "batch_stats": pair.var["batch_stats"]["backbone"]}
    out, vjp = jax.vjp(lambda p: pair.jmodel.backbone.apply(
        {"params": p, "batch_stats": bvars["batch_stats"]},
        jnp.asarray(feats), coords, gs, train=True,
        mutable=["batch_stats"], **kw)[0], bvars["params"])
    ct = rng.randn(*out.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(ct))
    ref = from_jax({"backbone": jax.tree.map(np.asarray, jg)}, {})

    middle = pair.port_model()[0].backbone.train()
    tplan = {k: torch.from_numpy(np.asarray(v)) for k, v in plan.items()}
    y = middle(torch.from_numpy(feats),
               torch.from_numpy(np.asarray(coords)), gs,
               plan=tplan if host else None)
    assert rel_l2(y.detach().numpy(), out) <= MIDDLE_GRAD_REL
    params = dict(middle.named_parameters())
    grads = torch.autograd.grad(y, list(params.values()),
                                torch.from_numpy(ct))
    names = [f"backbone.{n}" for n in params]
    for n, g in zip(names, grads):
        if n in cs.zero_grad_bias(names):
            continue
        err = rel_l2(g.numpy(), ref[n].numpy())
        assert err <= MIDDLE_GRAD_REL, (n, err)


def check_loss_eval(pair):
    jstate = pair.jax_state()
    ref = jax.jit(jloss_step(pair.jmodel, pair.jvg, pair.jasg,
                             pair.jcids))(
        jstate, {k: jnp.asarray(v) for k, v in pair.batch.items()})
    model, vg, asg, cids = pair.port_model()
    out = make_loss_eval_step(model, vg, asg, cids)(pair.batch)
    assert abs(float(out["loss"]) - float(ref["loss"])) <= LOSS_REL * abs(
        float(ref["loss"]))


# ---------------------------------------------------------------------------
# SECOND
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def second():
    return SparsePair("second", 1)


@pytest.fixture(scope="module", params=["host", "points"])
def second_run(second, request):
    return run_steps(second, second.batch if request.param == "host"
                     else second.scans)


def test_metrics_equal_jax(second_run):
    check_metrics(second_run)


def test_gradients_equal_jax(second_run):
    check_gradients(second_run)


def test_state_after_steps_equal_jax(second_run):
    check_state(second_run)


@pytest.mark.parametrize("host", [True, False])
def test_middle_gradients_equal_jax(second, host):
    check_middle(second, host)


def test_loss_eval_step_equals_jax(second):
    check_loss_eval(second)


def test_from_jax_covers_every_parameter_and_gradient():
    """Both middles' models at their shipped widths on the cut range:
    from_jax maps JAX's parameters, statistics and gradients (their trees
    and shapes, from ``jax.eval_shape``) onto every tensor of the port's
    model, at its shape."""
    for key in ("second", "cbgs"):
        cfg = cs.sparse_config(PATHS[key], cut=CUT)
        jm, jvg, jasg, jcids, _ = jbuild_stack(copy.deepcopy(cfg))
        scans = cs.sparse_train_scene(key, 1, cfg["voxel_generator"][
            "range"], 600, seed=4)
        ex = jax.jit(lambda b: jbuild_example(b, jvg, jasg, jcids))(
            {k: jnp.asarray(v) for k, v in scans.items()})

        def zeros(tree):
            return jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)

        var = zeros(jax.eval_shape(lambda e: jm.init(
            jax.random.PRNGKey(0), e["voxels"], e["num_points_per_voxel"],
            e["coordinates"], train=False), ex))

        def loss(p):
            preds, _ = jm.apply({"params": p,
                                 "batch_stats": var["batch_stats"]},
                                ex["voxels"], ex["num_points_per_voxel"],
                                ex["coordinates"], train=True,
                                mutable=["batch_stats"])
            return sum(jm.loss(ex, preds)["loss"])
        grads = zeros(jax.eval_shape(jax.grad(loss), var["params"]))
        model = build_stack(cfg, device="cpu")[0]
        carried = from_jax(var["params"], var["batch_stats"])
        assert sorted(carried) == sorted(model.state_dict())
        g = from_jax(grads, {})
        params = dict(model.named_parameters())
        assert sorted(g) == sorted(params)
        assert any(k.startswith("backbone.") for k in params)
        for k, p in params.items():
            assert g[k].shape == p.shape and carried[k].shape == p.shape, k
