"""Temporal align-and-aggregate, the port against the JAX package on the
CPU: models/temporal.py's ``correlation`` and ``align_feature`` at
patch sizes 3 and 9 (the window wider than the map too), and
``AlignFeatureAndAggregation`` with JAX's weights carried over by
utils/convert.py::from_jax (strict), forward and gradients.

The port sums the window slice by slice, JAX through an einsum over the
patch tensor: the ops agree within 1e-5 relative (of the largest
element), the module within 1e-4, its gradients within 1e-4 relative
L2, but for the biases whose effect the softmaxes cancel (CANCELLED),
whose gradients differ by less than 1e-4 of the largest parameter
gradient's norm. JAX runs under jax.jit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det3d_tpu.models import temporal as jt
from det3d_tpu_torch.models import temporal as tt
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


@pytest.mark.parametrize("patch", [3, 9])
def test_correlation_equal(rng, patch):
    a = rng.randn(2, 7, 6, 5).astype(np.float32)
    b = rng.randn(2, 7, 6, 5).astype(np.float32)
    fn = jax.jit(functools.partial(jt.correlation, patch_size=patch))
    got = tt.correlation(t(a), t(b), patch)
    assert got.shape == (2, 7, 6, patch * patch)
    close(got, fn(a, b), 1e-5)


def test_correlation_displacement_order(rng):
    """Displacement k = (dy + p//2) * p + (dx + p//2), zeros outside."""
    a = rng.randn(1, 5, 5, 3).astype(np.float32)
    b = rng.randn(1, 5, 5, 3).astype(np.float32)
    got = tt.correlation(t(a), t(b), 3).numpy()
    y, x = 2, 1
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = (dy + 1) * 3 + (dx + 1)
            want = float(a[0, y, x] @ b[0, y + dy, x + dx])
            np.testing.assert_allclose(got[0, y, x, k], want, rtol=1e-6)
    assert (got[0, 0, :, 0:3] == 0).all()         # dy = -1 off the top row


@pytest.mark.parametrize("patch", [3, 9])
def test_align_feature_equal(rng, patch):
    feat = rng.randn(2, 7, 6, 5).astype(np.float32)
    w = rng.rand(2, 7, 6, patch * patch).astype(np.float32)
    fn = jax.jit(functools.partial(jt.align_feature, patch_size=patch))
    got = tt.align_feature(t(feat), t(w), patch)
    close(got, fn(feat, w), 1e-5)


def jitter(params, rng):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32), params)


# parameters the softmaxes (nearly) cancel: the shared tower's biases shift
# both logits alike (their gradient is zero but for rounding), and the
# keyframe embedding's bias adds one constant to every in-frame
# displacement of a window, so that only windows leaving the frame feel it
# (a sum of cancelling terms: fp32 moves it ~3e-4 relative from float64,
# in the port and in JAX alike)
CANCELLED = {f"Aggregation_0.Conv_{i}.bias" for i in range(3)} | {
    "embed_keyframe_conv.bias"}


@pytest.mark.parametrize("neighbor", [3, 9])
def test_align_and_aggregate_equal(rng, neighbor):
    c = 12
    sel = rng.randn(2, 9, 8, c).astype(np.float32)
    cur = rng.randn(2, 9, 8, c).astype(np.float32)
    jm = jt.AlignFeatureAndAggregation(num_channel=c, neighbor=neighbor)
    params = jitter(jm.init(jax.random.PRNGKey(0), sel, cur)["params"], rng)
    m = tt.AlignFeatureAndAggregation(c, neighbor)
    m.load_state_dict(from_jax(params, {}), strict=True)
    cot = rng.randn(2, 9, 8, c).astype(np.float32)

    def loss(p, s, k):
        out = jm.apply({"params": p}, s, k)
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(params, sel, cur)
    ts, tc = t(sel).requires_grad_(), t(cur).requires_grad_()
    out = m(ts, tc)
    close(out.detach(), ref, 1e-4, "output")
    (out * t(cot)).sum().backward()
    assert rel_l2(ts.grad, grads[1]) < 1e-4
    assert rel_l2(tc.grad, grads[2]) < 1e-4
    ref_g = from_jax(grads[0], {})
    named = dict(m.named_parameters())
    assert set(named) == set(ref_g)
    top = max(float(np.linalg.norm(g)) for g in ref_g.values())
    for k, g in ref_g.items():
        if k in CANCELLED:
            err = np.linalg.norm(named[k].grad.numpy() - np.asarray(g))
            assert err < 1e-4 * top, k
        else:
            assert rel_l2(named[k].grad, g) < 1e-4, k


def test_align_and_aggregate_make_no_host_round_trip(rng):
    """The temporal block makes no tensor from host data and reads none
    back (tests/test_torch_predict_graph.py's lint), so it can be captured
    in a CUDA graph."""
    m = tt.AlignFeatureAndAggregation(8, 3)
    sel, cur = (t(rng.randn(1, 6, 5, 8).astype(np.float32))
                for _ in range(2))
    mode = HostRoundTrips()
    with mode:
        m(sel, cur)
    assert not mode.found, sorted(set(mode.found))
