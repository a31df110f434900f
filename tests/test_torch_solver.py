"""The solver: schedules and the optimizer against the JAX package's
(optax 0.2.6), on the CPU.

- every schedule of solver/schedules.py at steps 0 to 400 (and past its
  end) within 1e-6 of JAX's, through ``build_lr_schedule`` as a config
  names it;
- ``build_optimizer`` against the optax chain of JAX's ``build_optimizer``
  on identical gradients, 5 steps, on the small flagship's parameters
  carried across by ``from_jax``: Adam with the OneCycle momentum and
  decoupled weight decay, clipping on (gradients above the norm of 35)
  and off, Adam without a momentum schedule or without FIXED_WD, SGD with
  momentum and RMSprop. Parameters and moments within 1e-6 (relative to
  each tensor's scale), the pre-clip norm within 1e-6 relative. Adam's
  first step turns a gradient into its sign, so the gradients here are
  kept clear of zero;
- the port's weight-decay mask (BatchNorm scales and biases by module
  type) equal to JAX's ``_non_bn_mask`` (by path name), tensor by tensor
  through ``from_jax``.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from __graft_entry__ import _build_flagship
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.solver import optim as joptim
from det3d_tpu.solver import schedules as jsched
from det3d_tpu.utils.synth import structured_batch
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.solver import optim, schedules
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_modules import PC, SMALL

torch.set_num_threads(2)

TOTAL = 300
STEPS = list(range(0, 401, 7)) + [119, 120, 121, 299, 300, 301]
SCHEDULES = {
    "one_cycle": dict(type="one_cycle", lr_max=0.003, moms=[0.95, 0.85],
                      div_factor=10.0, pct_start=0.4),
    "one_cycle_short": dict(type="one_cycle", lr_max=0.01, moms=[0.9, 0.8],
                            div_factor=25.0, pct_start=0.1),
    "exponential": dict(type="exponential_decay", initial_learning_rate=2e-3,
                        decay_length=0.1, decay_factor=0.8),
    "exponential_smooth": dict(type="exponential_decay",
                               initial_learning_rate=2e-3, decay_length=0.1,
                               decay_factor=0.8, staircase=False),
    "manual": dict(type="manual_stepping", boundaries=[0.3, 0.6, 0.9],
                   rates=[1e-3, 5e-4, 1e-4, 1e-5]),
    "fixed": dict(policy="fixed", base_lr=0.01),
    "step_list": dict(policy="step", step=[2, 5], gamma=0.5, base_lr=0.01),
    "step_int": dict(policy="step", step=3, gamma=0.1, base_lr=0.01),
    "exp": dict(policy="exp", gamma=0.9, base_lr=0.01),
    "poly": dict(policy="poly", power=0.9, min_lr=1e-5, base_lr=0.01),
    "inv": dict(policy="inv", gamma=0.05, power=0.75, base_lr=0.01),
    "cosine": dict(policy="cosine", target_lr=1e-5, base_lr=0.01),
    "cosine_linear_warmup": dict(policy="cosine", base_lr=0.01,
                                 warmup="linear", warmup_iters=50,
                                 warmup_ratio=0.2),
    "step_constant_warmup": dict(policy="step", step=[3], base_lr=0.01,
                                 warmup="constant", warmup_iters=40,
                                 warmup_ratio=0.3),
    "poly_exp_warmup": dict(policy="poly", base_lr=0.01, by_epoch=False,
                            warmup="exp", warmup_iters=30, warmup_ratio=0.1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_jax(name):
    cfg = SCHEDULES[name]
    fns = schedules.build_lr_schedule(cfg, TOTAL, steps_per_epoch=40)
    jfns = jsched.build_lr_schedule(cfg, TOTAL, steps_per_epoch=40)
    assert (fns[1] is None) == (jfns[1] is None)
    step = torch.tensor(STEPS, dtype=torch.int32)
    for fn, jfn in zip(fns, jfns):
        if fn is None:
            continue
        out = fn(step)
        assert out.dtype == torch.float32 and out.shape == step.shape
        # JAX's schedules take one step (vmap over them)
        ref = np.asarray(jax.vmap(jfn)(jnp.asarray(STEPS, jnp.int32)))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-9)
        # one step at a time, as the optimizer's 0-d count
        for s in (0, 121, 300):
            np.testing.assert_allclose(
                fn(torch.tensor(s, dtype=torch.int32)).numpy(),
                np.asarray(jfn(jnp.int32(s))), rtol=1e-6, atol=1e-9)


def test_schedule_errors():
    with pytest.raises(ValueError):
        schedules.build_lr_schedule(dict(policy="cosine"), TOTAL)
    with pytest.raises(ValueError):
        schedules.build_lr_schedule(dict(type="nope", base_lr=1.0), TOTAL)
    with pytest.raises(ValueError):
        schedules.with_warmup(schedules.fixed_lr(1.0), "cubic", 10)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    """(JAX params as numpy, the port's small flagship carrying them)."""
    model, vg, asg, cids = _build_flagship(small=True, **SMALL)
    batch = structured_batch(1, 500, PC, seed=1)
    ex = jbuild_example({k: jnp.asarray(v) for k, v in batch.items()}, vg,
                        asg, cids, with_targets=False)
    var = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), ex["voxels"], ex["num_points_per_voxel"],
        ex["coordinates"], train=False)
    params = jax.tree.map(np.asarray, var["params"])
    stats = jax.tree.map(np.asarray, var["batch_stats"])
    tmodel = build_stack(flagship_config(small=True, **SMALL),
                         device="cpu")[0]
    tmodel.load_state_dict(from_jax(params, stats))
    return params, stats, tmodel


OPTIMIZERS = {
    "adam_one_cycle_clip": (dict(TYPE="adam", VALUE=dict(wd=0.01),
                                 FIXED_WD=True), "one_cycle", 35.0, 3.0),
    "adam_one_cycle_noclip": (dict(TYPE="adam", VALUE=dict(wd=0.01),
                                   FIXED_WD=True), "one_cycle", None, 3.0),
    "adam_no_mom": (dict(TYPE="adam", VALUE=dict(wd=0.05), FIXED_WD=True),
                    "exponential", 35.0, 0.01),
    "adam_no_wd": (dict(TYPE="adam", VALUE=dict(wd=0.01), FIXED_WD=False),
                   "one_cycle", 35.0, 0.01),
    "sgd": (dict(TYPE="sgd", VALUE=dict(momentum_optimizer_value=0.8)),
            "cosine", 35.0, 0.01),
    "rms_prop": (dict(TYPE="rms_prop", VALUE=dict(
        decay=0.95, momentum_optimizer_value=0.5, epsilon=1e-6)), "fixed",
        None, 0.01),
}


def random_grads(params, seed, scale):
    """A gradient tree of the params' shapes, each entry of magnitude at
    least 0.1 * scale (clear of zero)."""
    r = np.random.RandomState(seed)

    def one(p):
        g = r.normal(0, 1, p.shape).astype(np.float32)
        return (np.sign(g) * (np.abs(g) + 0.1) * scale).astype(np.float32)
    return jax.tree.map(one, params)


def rel_close(out, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= tol, (what, err)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_equals_optax(flagship, name):
    params, stats, tmodel = flagship
    cfg, sched, clip, grad_scale = OPTIMIZERS[name]
    lr_fn, mom_fn = schedules.build_lr_schedule(SCHEDULES[sched], 5,
                                                steps_per_epoch=1)
    jlr, jmom = jsched.build_lr_schedule(SCHEDULES[sched], 5,
                                         steps_per_epoch=1)
    tx = joptim.build_optimizer(cfg, jlr, jmom, grad_clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    tmodel.load_state_dict(from_jax(params, stats))
    port = optim.build_optimizer(cfg, tmodel, lr_fn, mom_fn,
                                 grad_clip_norm=clip)
    norms = []
    for i in range(5):
        g = random_grads(params, i, grad_scale)
        updates, opt_state = update(jax.tree.map(jnp.asarray, g),
                                    opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = from_jax(g, {})
        norm = port.update([tg[n] for n in port.names])
        ref_norm = float(optax.global_norm(g))
        norms.append(ref_norm)
        assert abs(float(norm) - ref_norm) <= 1e-6 * ref_norm
    assert int(port.count) == 5
    if clip is not None and grad_scale > 1:
        assert min(norms) > clip            # every step clipped
    ref = from_jax(jax.tree.map(np.asarray, jp), stats)
    sd = tmodel.state_dict()
    for k, p in tmodel.named_parameters():
        rel_close(sd[k].numpy(), ref[k].numpy(), 1e-6, k)
    # the moments, by parameter name, through the same converter
    leaves = jax.tree_util.tree_leaves_with_path(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") or hasattr(x, "nu")
        or hasattr(x, "trace"))
    found = 0
    for _, leaf in leaves:
        for key in ("mu", "nu", "trace"):
            tree = getattr(leaf, key, None)
            if not isinstance(tree, dict) or getattr(port, key) is None:
                continue
            ref_m = from_jax(jax.tree.map(np.asarray, tree), {})
            ours = port.state_dict()[key]
            for k in ours:
                rel_close(ours[k].numpy(), ref_m[k].numpy(), 1e-6,
                          f"{key} {k}")
            found += 1
    assert found == sum(getattr(port, k) is not None
                        for k in ("mu", "nu", "trace"))


def test_decay_mask_equals_non_bn_mask(flagship):
    params, _, tmodel = flagship
    jmask = joptim._non_bn_mask(params)
    full = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), jmask,
                        params)
    ref = from_jax(full, {})
    mask = optim.non_bn_mask(tmodel)
    assert sorted(mask) == sorted(ref)
    for k, decayed in mask.items():
        assert bool((ref[k] == 1.0).all()) == decayed, k
        assert bool((ref[k] == 0.0).all()) != decayed, k
    flat = traverse_util.flatten_dict(params)
    n_bn = sum("BatchNorm" in "/".join(p) for p in flat)
    assert sum(not d for d in mask.values()) == n_bn > 0


def test_global_norm_and_clip_without_epsilon():
    """The clip is optax's: a norm exactly at the limit is scaled (to
    itself), one below is left alone, and no epsilon enters the scale."""
    g = [torch.full((4,), 10.0), torch.full((9,), 5.0)]   # norm 25
    assert float(optim.global_norm(g)) == 25.0
    for clip, want in ((25.0, 25.0), (30.0, 25.0), (5.0, 5.0)):
        p = torch.nn.Parameter(torch.zeros(13))
        opt = optim.Optimizer([("p", p)], "sgd", schedules.fixed_lr(1.0),
                              grad_clip_norm=clip)
        opt.update([torch.cat(g)])
        assert float(p.norm()) == pytest.approx(want, rel=1e-7)
