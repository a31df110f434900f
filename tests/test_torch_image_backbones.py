"""Image backbones and FPN, the port against the JAX package on the CPU:
models/image_backbones.py's ResNet-18 and -50 (eval, 64 x 64), a training
step with frozen stages under ``norm_eval`` and without it, SENet,
SSDVGG300's and SSDVGG512's pyramids, FPN at an odd input size (where
torch's "nearest-exact" and JAX's nearest resize agree and "nearest"
does not) with max-pool and conv extra levels, and the registries and
models/builder.py's per-part builders. Random variables in the shapes of
JAX's init (random_variables) go into the JAX module and, through
utils/convert.py::from_jax (strict), into the port's.

Tolerances: outputs within 1e-4 (relative, of the largest element),
gradients within 1e-4 relative L2, running statistics within 1e-5.
JAX runs under jax.jit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from det3d_tpu.models import image_backbones as ji
from det3d_tpu_torch.models import builder
from det3d_tpu_torch.models import image_backbones as ti
from det3d_tpu_torch.models.registry import BACKBONES, NECKS
from det3d_tpu_torch.utils.convert import from_jax

torch.set_num_threads(4)


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-12)


def random_variables(shapes, rng):
    """Variables of the shapes flax's init gives (``jax.eval_shape``; the
    init itself compiles for seconds), drawn from ``rng``: kernels normal
    over sqrt(fan in), biases, BN scales and statistics and L2Norm's gamma
    random around their initial values."""
    def f(path, x):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(x.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        base = {"scale": 1.0, "gamma": 20.0}.get(name, 0.0)
        return (base + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
    return {col: jax.tree_util.tree_map_with_path(f, tree)
            for col, tree in shapes.items()}


def carried(jmod, tmod, x, rng):
    """Random variables of ``jmod`` on ``x`` and ``tmod`` loaded with them
    (strict)."""
    v = random_variables(jax.eval_shape(
        lambda x: jmod.init(jax.random.PRNGKey(0), x, train=False), x), rng)
    tmod.load_state_dict(from_jax(v["params"], v.get("batch_stats", {})),
                         strict=True)
    return v


def check_eval(jmod, tmod, x, rng, shapes=None):
    v = carried(jmod, tmod, x, rng)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(v, x)
    tmod.eval()
    with torch.no_grad():
        got = tmod(t(x) if not isinstance(x, list) else [t(a) for a in x])
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert tuple(g.shape) == tuple(r.shape), i
        close(g, r, 1e-4, f"output {i}")
    if shapes is not None:
        assert [tuple(g.shape[1:]) for g in got] == shapes
    return got


@pytest.mark.parametrize("depth,chans", [(18, (64, 128, 256, 512)),
                                         (50, (256, 512, 1024, 2048))])
def test_resnet_eval_equal(rng, depth, chans):
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    check_eval(ji.ResNet(depth=depth), ti.ResNet(depth=depth), x, rng,
               [(64 // (4 * 2 ** i), 64 // (4 * 2 ** i), c)
                for i, c in enumerate(chans)])


@pytest.mark.parametrize("norm_eval", [True, False])
def test_resnet_frozen_training_step(rng, norm_eval):
    """frozen_stages=1: the stem and stage 1 get no gradient and keep their
    running statistics; with norm_eval every BN keeps them, without it the
    later stages' move as JAX's do."""
    kw = dict(depth=18, frozen_stages=1, norm_eval=norm_eval,
              out_indices=(1, 3))
    jm, tm = ji.ResNet(**kw), ti.ResNet(**kw)
    # 64 x 64: the last stage's BN sums 8 values a channel (at 32 x 32, 2:
    # fp32 moves its training gradients ~2e-4 from float64 in both)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    v = carried(jm, tm, x, rng)
    outs = jax.eval_shape(lambda: jm.apply(v, x, train=False))
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, x,
                            train=True, mutable=["batch_stats"])
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), (
            out, upd["batch_stats"])

    (_, (ref, stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    before = {k: b.clone() for k, b in tm.named_buffers()}
    tm.train()
    out = tm(t(x))
    for i, (g, r) in enumerate(zip(out, ref)):
        close(g.detach(), r, 1e-4, f"output {i}")
    sum((o * t(c)).sum() for o, c in zip(out, cots)).backward()
    ref_g = from_jax(grads, {})
    frozen = ("Conv_0.", "MaskedBatchNorm_0.", "BasicBlock_0.",
              "BasicBlock_1.")
    for k, p in tm.named_parameters():
        if k.startswith(frozen):
            assert p.grad is None, k
            assert not np.asarray(ref_g[k]).any(), k
        else:
            assert rel_l2(p.grad, ref_g[k]) < 1e-4, k
    ref_stats = from_jax(v["params"], stats)
    moved = 0
    for k, b in tm.named_buffers():
        close(b, ref_stats[k], 1e-5, k)
        if k.startswith(frozen) or norm_eval:
            assert torch.equal(b, before[k]), k
        moved += not torch.equal(b, before[k])
    assert moved == 0 if norm_eval else moved > 0


def test_senet_equal(rng):
    x = rng.randn(1, 32, 32, 3).astype(np.float32)
    kw = dict(depth=50, reduction=16, out_indices=(0, 1), num_stages=2)
    tm = ti.SENet(**kw)
    check_eval(ji.SENet(**kw), tm, x, rng, [(8, 8, 256), (4, 4, 512)])
    assert "ResNet_0.Bottleneck_0.Dense_1.weight" in tm.state_dict()


@pytest.mark.parametrize("size,shapes", [
    (300, [(38, 38, 512), (19, 19, 1024), (10, 10, 512), (5, 5, 256),
           (3, 3, 256), (1, 1, 256)]),
    (512, [(64, 64, 512), (32, 32, 1024), (16, 16, 512), (8, 8, 256),
           (4, 4, 256), (2, 2, 256), (1, 1, 256)])])
def test_ssdvgg_pyramid_equal(rng, size, shapes):
    x = rng.randn(1, size, size, 3).astype(np.float32)
    check_eval(ji.SSDVGG(input_size=size), ti.SSDVGG(input_size=size), x,
               rng, shapes)


@pytest.mark.parametrize("extra", ["pool", "conv_inputs", "conv_outputs"])
def test_fpn_odd_size_equal(rng, extra):
    """A (25, 19) map's levels: 13 x 10, 7 x 5 and 4 x 3, none an exact
    multiple of the next."""
    sizes = [(25, 19), (13, 10), (7, 5), (4, 3)]
    chans = [8, 16, 24, 32]
    x = [rng.randn(1, h, w, c).astype(np.float32)
         for (h, w), c in zip(sizes, chans)]
    kw = dict(in_channels=chans, out_channels=8, num_outs=6)
    if extra != "pool":
        kw.update(add_extra_convs=True,
                  extra_convs_on_inputs=extra == "conv_inputs",
                  relu_before_extra_convs=True)
    got = check_eval(ji.FPN(**kw), ti.FPN(**kw), x, rng)
    assert [tuple(g.shape[1:3]) for g in got] == sizes + [(2, 2), (1, 1)]


def test_nearest_exact_is_jax_nearest():
    """The upsample FPN needs: 4 -> 7 rows."""
    x = np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1) * 4
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 7, 1, 1),
                                       "nearest"))[0, :, 0, 0]
    exact = F.interpolate(t(x).permute(0, 3, 1, 2), size=(7, 1),
                          mode="nearest-exact")[0, 0, :, 0]
    plain = F.interpolate(t(x).permute(0, 3, 1, 2), size=(7, 1),
                          mode="nearest")[0, 0, :, 0]
    assert want.tolist() == [0, 0, 4, 8, 8, 12, 12] == exact.tolist()
    assert plain.tolist() != want.tolist()


def test_registry_and_builders():
    for name in ("ResNet", "SENet", "SSDVGG"):
        assert BACKBONES.get(name) is getattr(ti, name)
    assert NECKS.get("FPN") is ti.FPN
    bb = builder.build_backbone(dict(type="ResNet", depth=18,
                                     frozen_stages=1, name="r18"))
    assert isinstance(bb, ti.ResNet) and bb.frozen_stages == 1
    neck = builder.build_neck(dict(type="FPN", in_channels=[64, 128],
                                   out_channels=16, num_outs=3))
    assert isinstance(neck, ti.FPN) and neck.num_extra == 1
    x = torch.zeros(1, 64, 64, 3)
    bb.eval()
    outs = neck(list(bb(x)[:2]))
    assert [tuple(o.shape) for o in outs] == [(1, 16, 16, 16),
                                              (1, 8, 8, 16), (1, 4, 4, 16)]
    loss = builder.build_loss(dict(type="WeightedSmoothL1Loss"))
    assert type(loss).__name__ == "WeightedSmoothL1Loss"
