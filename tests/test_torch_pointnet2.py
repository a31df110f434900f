"""PointNet++ ops and modules, the port against the JAX package on the CPU:
ops/pointnet2.py (square distances, farthest-point sampling, ball query,
grouping, 3-NN interpolation) and models/point_modules.py (SharedMLP,
the MSG and GroupAll set abstractions, feature propagation with and
without skip features and the global broadcast), with JAX's weights
carried over by utils/convert.py::from_jax (strict).

Tolerances: integer outputs equal (FPS indices with duplicate points and
with fewer valid points than npoint; ball-query idx and found, chunked
and not, every point 1e-3 clear of the radius; 3-NN idx with at least 3
valid known points); distances and interpolations within 1e-5 relative;
module outputs within 1e-4; gradients within 1e-4 relative L2; running
statistics within 1e-5. JAX runs under jax.jit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det3d_tpu.models import point_modules as jpm
from det3d_tpu.ops import pointnet2 as jp2
from det3d_tpu_torch.models import point_modules as pm
from det3d_tpu_torch.ops import pointnet2 as p2
from det3d_tpu_torch.utils.convert import from_jax
from tests.test_torch_predict_graph import HostRoundTrips

torch.set_num_threads(2)


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


def clear_of_radius(rng, n, centers, radii, lo=-1.0, hi=1.0, gap=1e-3):
    """n points in [lo, hi)^3, each at least ``gap`` from every sphere of
    every radius around every center (float64)."""
    pts = rng.uniform(lo, hi, (n, 3))
    for _ in range(100):
        d = np.linalg.norm(pts[:, None] - centers[None], axis=-1)
        bad = np.zeros(n, bool)
        for r in radii:
            bad |= (np.abs(d - r) < gap).any(1)
        if not bad.any():
            return pts.astype(np.float32)
        pts[bad] = rng.uniform(lo, hi, (int(bad.sum()), 3))
    raise AssertionError("could not keep the points clear of the radius")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_square_distance(rng):
    a = rng.randn(2, 30, 3).astype(np.float32)
    b = rng.randn(2, 50, 3).astype(np.float32)
    ref = jax.jit(jp2.square_distance)(a, b)
    got = p2.square_distance(t(a), t(b))
    assert got.shape == (2, 30, 50)
    close(got, ref, 1e-5)


def fps_cases(rng):
    xyz = rng.randn(2, 64, 3).astype(np.float32)
    dup = np.repeat(rng.randn(2, 16, 3).astype(np.float32), 4, axis=1)
    few = np.ones((2, 64), bool)
    few[0, 5:] = False                      # 5 valid points, npoint 16
    few[1, :40] = False                     # the first valid is point 40
    holes = rng.rand(2, 64) > 0.3
    return {"random": (xyz, None), "duplicates": (dup, None),
            "fewer_valid_than_npoint": (xyz, few), "masked": (xyz, holes)}


@pytest.mark.parametrize("case", ["random", "duplicates",
                                  "fewer_valid_than_npoint", "masked"])
def test_furthest_point_sample_equal(rng, case):
    xyz, valid = fps_cases(rng)[case]
    fn = jax.jit(functools.partial(jp2.furthest_point_sample, npoint=16))
    ref = np.asarray(fn(xyz, valid=valid))
    got = p2.furthest_point_sample(
        t(xyz), 16, None if valid is None else t(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    if valid is not None and case == "masked":
        assert valid[np.arange(2)[:, None], got.numpy()].all()


def test_gather_and_group(rng):
    feats = rng.randn(2, 12, 4).astype(np.float32)
    idx = rng.randint(0, 12, (2, 5, 3))
    got = p2.group_points(t(feats), t(idx)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jp2.group_points(feats, idx.astype(np.int32))))
    g = p2.gather_points(t(feats), t(idx[:, :, 0])).numpy()
    np.testing.assert_array_equal(
        g, np.asarray(jp2.gather_points(feats, idx[:, :, 0].astype(
            np.int32))))


@pytest.mark.parametrize("chunk", [16, 4096])
@pytest.mark.parametrize("masked", [False, True])
def test_ball_query_equal(rng, chunk, masked):
    centers = rng.uniform(-1, 1, (2, 40, 3))
    radii = (0.3, 0.6)
    xyz = np.stack([clear_of_radius(rng, 128, centers[b], radii)
                    for b in range(2)])
    centers = centers.astype(np.float32)
    valid = rng.rand(2, 128) > 0.25 if masked else None
    for radius, nsample in zip(radii, (8, 16)):
        fn = jax.jit(functools.partial(jp2.ball_query, radius=radius,
                                       nsample=nsample, chunk=chunk))
        ridx, rfound = fn(xyz, centers, valid=valid)
        idx, found = p2.ball_query(t(xyz), t(centers), radius, nsample,
                                   None if valid is None else t(valid),
                                   chunk=chunk)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_array_equal(found.numpy(), np.asarray(rfound))
        assert found.any() and not found.all()
    # chunked equals unchunked
    a = p2.ball_query(t(xyz), t(centers), 0.6, 16, chunk=7)
    b = p2.ball_query(t(xyz), t(centers), 0.6, 16, chunk=4096)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_ball_query_empty_ball_pads_with_zero():
    xyz = torch.tensor([[[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [5.0, 5, 5],
                         [6.0, 6, 6], [7.0, 7, 7]]])
    centers = torch.tensor([[[0.05, 0.0, 0.0], [9.0, 9.0, 9.0]]])
    idx, found = p2.ball_query(xyz, centers, 0.5, 4)
    assert idx.tolist() == [[[0, 1, 0, 0], [0, 0, 0, 0]]]
    assert found.tolist() == [[[True, True, False, False], [False] * 4]]


@pytest.mark.parametrize("masked", [False, True])
def test_three_nn_interpolate_equal(rng, masked):
    unknown = rng.randn(2, 24, 3).astype(np.float32)
    known = rng.randn(2, 10, 3).astype(np.float32)
    feats = rng.randn(2, 10, 5).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((2, 10), bool)
        valid[0, [1, 4, 7]] = False
        valid[1, 3:] = False                      # 3 valid known points
    rdist, ridx = jax.jit(jp2.three_nn)(unknown, known, valid)
    dist, idx = p2.three_nn(t(unknown), t(known),
                            None if valid is None else t(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    close(dist, rdist, 1e-5, "dist")
    w = p2.interpolation_weights(dist)
    rw = jax.jit(jp2.interpolation_weights)(rdist)
    close(w, rw, 1e-5, "weights")
    out = p2.three_interpolate(t(feats), idx, w)
    rout = jax.jit(jp2.three_interpolate)(feats, ridx, rw)
    close(out, rout, 1e-5, "interpolation")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def jitter(variables, rng):
    """The init's variables with random BN scale / bias / statistics, so
    every carried tensor matters."""
    out = {}
    for col, tree in variables.items():
        def f(path, x):
            x = np.asarray(x)
            name = path[-1].key
            if name == "var":
                return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
            if name in ("scale", "mean", "bias"):
                return (x + 0.2 * rng.randn(*x.shape)).astype(x.dtype)
            return x
        out[col] = jax.tree_util.tree_map_with_path(f, tree)
    return out


def load(module, variables):
    module.load_state_dict(from_jax(variables["params"],
                                    variables.get("batch_stats", {})),
                           strict=True)
    return module


def jax_grads(jmod, variables, args, kwargs, cot):
    """Gradients of sum(out * cot) with respect to the params, in training
    mode, and the updated batch statistics, under jax.jit."""
    def loss(params):
        out, upd = jmod.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              *args, train=True, mutable=["batch_stats"],
                              **kwargs)
        out = out[1] if isinstance(out, tuple) else out
        return jnp.sum(out * cot), (out, upd["batch_stats"])
    (_, (out, stats)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    return np.asarray(out), stats, from_jax(g, {})


def check_train_step(module, variables, out, cot, ref_out, ref_stats,
                     ref_grads):
    close(out.detach(), ref_out, 1e-4, "train-mode output")
    (out * t(cot)).sum().backward()
    sd = dict(module.named_parameters())
    assert set(sd) == set(ref_grads)
    for k, g in ref_grads.items():
        assert rel_l2(sd[k].grad, g) < 1e-4, k
    stats = from_jax(variables["params"], ref_stats)
    for k, b in module.named_buffers():
        close(b, stats[k], 1e-5, k)


def sa_inputs(rng, b=2, n=64, c=6):
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    valid = rng.rand(b, n) > 0.2
    return xyz, feats, valid


@pytest.mark.parametrize("with_feats", [True, False])
def test_sa_msg_equal(rng, with_feats):
    xyz, feats, valid = sa_inputs(rng)
    feats = feats if with_feats else None
    c = 6 if with_feats else 0
    kw = dict(npoint=16, radii=[0.5, 1.0], nsamples=[8, 16],
              mlps=[[16, 16], [16, 32]])
    jsa = jpm.PointnetSAModuleMSG(**kw)
    v = jitter(jsa.init(jax.random.PRNGKey(0), xyz, feats, valid,
                        train=False), rng)
    sa = load(pm.PointnetSAModuleMSG(in_channels=c, **kw), v)
    # eval
    rx, rf, rv = jax.jit(lambda *a: jsa.apply(v, *a, train=False))(
        xyz, feats, valid)
    sa.eval()
    nx, nf, nv = sa(t(xyz), None if feats is None else t(feats), t(valid))
    close(nx, rx, 1e-6, "new_xyz")
    np.testing.assert_array_equal(nv.numpy(), np.asarray(rv))
    close(nf.detach(), rf, 1e-4, "eval features")
    # one training step
    cot = rng.randn(*rf.shape).astype(np.float32)
    args = (xyz, feats, valid)
    ref_out, ref_stats, ref_grads = jax_grads(jsa, v, args, {}, cot)
    sa.train()
    _, out, _ = sa(t(xyz), None if feats is None else t(feats), t(valid))
    check_train_step(sa, v, out, cot, ref_out, ref_stats, ref_grads)


def test_sa_group_all_equal(rng):
    xyz, feats, valid = sa_inputs(rng, n=32, c=4)
    jsa = jpm.PointnetSAModule(mlp=[16, 24], npoint=None)
    v = jitter(jsa.init(jax.random.PRNGKey(1), xyz, feats, valid,
                        train=False), rng)
    sa = load(pm.PointnetSAModule(mlp=[16, 24], npoint=None, in_channels=4),
              v)
    sa.eval()
    rx, rf, rv = jax.jit(lambda *a: jsa.apply(v, *a, train=False))(
        xyz, feats, valid)
    nx, nf, nv = sa(t(xyz), t(feats), t(valid))
    assert nf.shape == (2, 1, 24) and nv is None and rv is None
    np.testing.assert_array_equal(nx.numpy(), np.asarray(rx))
    close(nf.detach(), rf, 1e-4)
    cot = rng.randn(*rf.shape).astype(np.float32)
    ref_out, ref_stats, ref_grads = jax_grads(jsa, v, (xyz, feats, valid),
                                              {}, cot)
    sa.train()
    _, out, _ = sa(t(xyz), t(feats), t(valid))
    check_train_step(sa, v, out, cot, ref_out, ref_stats, ref_grads)


@pytest.mark.parametrize("mode", ["skip", "no_skip", "global"])
def test_fp_equal(rng, mode):
    unknown = rng.uniform(-1, 1, (2, 48, 3)).astype(np.float32)
    known = rng.uniform(-1, 1, (2, 12, 3)).astype(np.float32)
    skip = rng.randn(2, 48, 5).astype(np.float32)
    kfeat = rng.randn(2, 12, 7).astype(np.float32)
    kvalid = np.ones((2, 12), bool)
    kvalid[1, 8:] = False
    if mode == "global":
        known, kvalid, kfeat = None, None, kfeat[:, :1]
    unknown_feats = None if mode == "no_skip" else skip
    cin = 7 + (0 if unknown_feats is None else 5)
    jfp = jpm.PointnetFPModule(mlp=[16, 8])
    args = (unknown, known, unknown_feats, kfeat, kvalid)
    v = jitter(jfp.init(jax.random.PRNGKey(2), *args, train=False), rng)
    fp = load(pm.PointnetFPModule(mlp=[16, 8], in_channels=cin), v)
    tin = [None if a is None else t(a) for a in args]
    fp.eval()
    ref = jax.jit(lambda *a: jfp.apply(v, *a, train=False))(*args)
    close(fp(*tin).detach(), ref, 1e-4, "eval")
    cot = rng.randn(*ref.shape).astype(np.float32)
    ref_out, ref_stats, ref_grads = jax_grads(jfp, v, args, {}, cot)
    fp.train()
    check_train_step(fp, v, fp(*tin), cot, ref_out, ref_stats, ref_grads)


def test_query_and_group_normalized(rng):
    xyz = rng.uniform(-1, 1, (1, 40, 3)).astype(np.float32)
    new_xyz = xyz[:, :6] + 0.01
    feats = rng.randn(1, 40, 2).astype(np.float32)
    ref = jpm.query_and_group(jnp.asarray(xyz), jnp.asarray(new_xyz),
                              jnp.asarray(feats), 0.5, 8,
                              normalize_xyz=True)
    got = pm.query_and_group(t(xyz), t(new_xyz), t(feats), 0.5, 8,
                             normalize_xyz=True)
    close(got[0], ref[0], 1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_sa_fp_make_no_host_round_trip(rng):
    """The set abstraction (FPS, ball query, grouping, the masked max-pool)
    and the feature propagation make no tensor from host data and read
    none back, so a step that runs them can be captured in a CUDA graph
    (tests/test_torch_predict_graph.py's lint)."""
    xyz, feats, valid = (t(a) for a in sa_inputs(rng))
    sa = pm.PointnetSAModuleMSG(npoint=16, radii=[0.5, 1.0],
                                nsamples=[8, 16], mlps=[[16], [16, 32]],
                                in_channels=6)
    fp = pm.PointnetFPModule(mlp=[16], in_channels=48 + 6)
    mode = HostRoundTrips()
    with mode:
        for training in (False, True):
            sa.train(training)
            fp.train(training)
            new_xyz, new_feats, new_valid = sa(xyz, feats, valid)
            fp(xyz, new_xyz, feats, new_feats, known_valid=new_valid)
    assert not mode.found, sorted(set(mode.found))
