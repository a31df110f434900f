"""The sparse engine's general cases, the port against the JAX package on
the CPU: grids deeper than 64 (dense and sorted lookup tables, flat
per-tap rulebooks, the flat convolution and its autograd backward, deep
middles from the device plan) and strided window convs without an inverse
rulebook (the flat per-tap dX through window_to_flat); a deep middle
against JAX's: tests/test_torch_deep_middle.py.

Mirrors tests/test_sparse.py's flat cases: test_window_subm_matches_flat
(:256), test_window_strided_matches_flat (:277),
test_window_strided_grad_matches_flat (:332) and
test_inverse_rulebook_strided_grad_matches_flat (:355). Tolerances:
rulebooks, tables and plans equal; convs and middles within 1e-4 (rtol,
atol 1e-4 of the largest); gradients within 1e-4 relative L2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from det3d_tpu.ops import sparse as jsp
from det3d_tpu_torch.models import backbones as bb
from det3d_tpu_torch.ops import sparse as sp
from det3d_tpu_torch.ops.window_conv_cuda import window_conv
from tests.test_torch_variants import close, rel_l2

torch.set_num_threads(2)

TOL = 1e-4
SHAPE = (5, 9, 11)              # the JAX tests' (D, H, W)
DEEP = (81, 16, 16)             # a deep grid: SECOND's depth at 0.05 m z
DEEP_GRID = (16, 16, 80)        # its (nx, ny, nz)


def voxel_batch(rng, b, n_active, v_pad, c, shape):
    """Unique random voxels, b samples padded to v_pad rows."""
    d, h, w = shape
    co = np.full((b, v_pad, 3), -1, np.int32)
    feats = np.zeros((b, v_pad, c), np.float32)
    for i in range(b):
        lin = rng.choice(d * h * w, n_active - 3 * i, replace=False)
        co[i, :len(lin)] = np.stack([lin // (h * w), (lin // w) % h,
                                     lin % w], -1)
        feats[i, :len(lin)] = rng.randn(len(lin), c)
    return feats, co


def jstage_lookup(co, shape):
    """JAX's stage_lookup_batch under jax.jit (op by op its first run
    compiles each op): (order, coords, lookup)."""
    kind = "bitmap" if shape[0] <= 64 else "dense"
    order, jco, data = jax.jit(lambda c: (lambda r: (r[0], r[1], r[2][1]))(
        jsp.stage_lookup_batch(c, shape)))(jnp.asarray(co))
    return order, jco, (kind, data)


def ranked(rng, b, n_active, v_pad, c, shape):
    """Both packages' rank-ordered rows and lookups (tests/test_sparse.py::
    _ranked): (feats, coords, port lookup, JAX lookup)."""
    feats, co = voxel_batch(rng, b, n_active, v_pad, c, shape)
    order, tco, lookup = sp.stage_lookup_batch(torch.from_numpy(co), shape)
    _, jco, jlookup = jstage_lookup(co, shape)
    np.testing.assert_array_equal(tco.numpy(), np.asarray(jco))
    f = torch.gather(torch.from_numpy(feats), 1,
                     order[..., None].expand(-1, -1, c))
    return f, tco, lookup, jlookup


def same_flat(got, ref):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


# ---------------------------------------------------------------------------
# windows against flat rulebooks (tests/test_sparse.py)
# ---------------------------------------------------------------------------

def test_window_subm_matches_flat(rng):
    """The flat rulebook of a bitmap lookup equals JAX's; the window conv
    (both center-column forms) equals flat_conv on it."""
    f, co, lookup, jlookup = ranked(rng, 2, 40, 64, 6, SHAPE)
    w = torch.from_numpy(rng.randn(27, 6, 8).astype(np.float32))
    flat = sp.subm_rulebook_batch(co, SHAPE, 3, lookup)

    def jflat(c, table, x, w_):
        idx, mask = jsp.subm_rulebook_batch(c, SHAPE, 3, ("bitmap", table))
        return idx, mask, jsp.apply_conv(x, idx, mask, w_)

    jidx, jmask, jref = jax.jit(jflat)(jnp.asarray(co.numpy()), jlookup[1],
                                       jnp.asarray(f.numpy()),
                                       jnp.asarray(w.numpy()))
    same_flat(flat, (jidx, jmask))
    ref = sp.flat_conv(f, *flat, w)
    r0, pres = sp.subm_window_rulebook_batch(co, SHAPE, 3, lookup)
    assert pres.dim() == 4
    close(sp.window_conv_ref(f, r0, pres, w, False).numpy(), ref, TOL)
    close(sp.window_conv_ref(f, r0, pres, w, True).numpy(), ref, TOL)
    close(sp.flat_conv(f, *flat, w, sp.center_column_taps(3)).numpy(), ref,
          TOL)
    close(ref.numpy(), jref, TOL)


@pytest.mark.parametrize("geom", [(3, 2, (0, 1, 1)), (3, 2, 1),
                                  ((3, 1, 1), (2, 1, 1), 0)])
def test_window_strided_matches_flat(rng, geom):
    kernel, stride, pad = geom
    f, co, lookup, jlookup = ranked(rng, 2, 35, 64, 4, SHAPE)
    kvol = 27 if kernel == 3 else 3
    w = torch.from_numpy(rng.randn(kvol, 4, 5).astype(np.float32))
    out_co, _ = sp.conv_out_coords(co, SHAPE, kernel, stride, pad, 128)
    flat = sp.conv_rulebook_batch(SHAPE, out_co, kernel, stride, pad, lookup)
    same_flat(flat, jax.jit(lambda oc, table: jsp.conv_rulebook_batch(
        SHAPE, oc, kernel, stride, pad, ("bitmap", table)))(
            jnp.asarray(out_co.numpy()), jlookup[1]))
    r0, pres = sp.conv_window_rulebook_batch(SHAPE, out_co, kernel, stride,
                                             pad, lookup)
    close(sp.window_conv_ref(f, r0, pres, w, False).numpy(),
          sp.flat_conv(f, *flat, w), TOL)


def _grads(fn, f, w):
    f = f.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    out = fn(f, w)
    (out ** 2).sum().backward()
    return out.detach(), f.grad, w.grad


@pytest.mark.parametrize("geom", [(3, 2, 1), (3, 1, 1), (5, 2, 2)])
def test_window_strided_grad_matches_flat(rng, geom):
    """A strided window conv without an inverse rulebook takes the flat
    per-tap dX (window_to_flat + flat_conv_dx; dW from the dW twin): equal
    to flat_conv's autograd and to JAX's apply_conv_window VJP, at k3/s2
    (the shipped geometry, without its training plan) and at 3 and 3
    output candidates a dim (k3/s1, k5/s2), which have none."""
    kernel, stride, pad = geom
    f, co, lookup, jlookup = ranked(rng, 1, 30, 48, 4, SHAPE)
    w = torch.from_numpy(rng.randn(kernel ** 3, 4, 4).astype(np.float32))
    out_co, _ = sp.conv_out_coords(co, SHAPE, kernel, stride, pad, 128)
    r0, pres = sp.conv_window_rulebook_batch(SHAPE, out_co, kernel, stride,
                                             pad, lookup)
    flat = sp.conv_rulebook_batch(SHAPE, out_co, kernel, stride, pad, lookup)
    packed = sp.pack_windows(r0, pres)
    out, gf, gw = _grads(lambda a, b: window_conv(a, packed, b, False), f, w)
    fout, fgf, fgw = _grads(lambda a, b: sp.flat_conv(a, *flat, b), f, w)
    close(out.numpy(), fout, TOL)
    assert rel_l2(gf, fgf) <= TOL and rel_l2(gw, fgw) <= TOL

    def jgrads(a, b, oc, table):
        r0_, pres_ = jsp.conv_window_rulebook_batch(
            SHAPE, oc, kernel, stride, pad, ("bitmap", table))
        return jax.grad(lambda a_, b_: (jsp.apply_conv(
            a_, r0_, pres_, b_) ** 2).sum(), argnums=(0, 1))(a, b)

    jgf, jgw = jax.jit(jgrads)(jnp.asarray(f.numpy()), jnp.asarray(w.numpy()),
                               jnp.asarray(out_co.numpy()), jlookup[1])
    assert rel_l2(gf, jgf) <= TOL and rel_l2(gw, jgw) <= TOL


@pytest.mark.parametrize("geom", [(3, 2, (0, 1, 1)),
                                  ((3, 1, 1), (2, 1, 1), 0)])
def test_inverse_rulebook_strided_grad_matches_flat(rng, geom):
    """The inverse-rulebook dX (window_conv_inv's twin) equals the flat
    per-tap dX, at the asymmetric-pad downsample and the z collapse."""
    kernel, stride, pad = geom
    f, co, lookup, _ = ranked(rng, 2, 35, 64, 4, SHAPE)
    kvol = 27 if kernel == 3 else 3
    w = torch.from_numpy(rng.randn(kvol, 4, 8).astype(np.float32))
    out_co, oshape = sp.conv_out_coords(co, SHAPE, kernel, stride, pad, 128)
    _, out_co, out_lookup = sp.stage_lookup_batch(out_co, oshape)
    packed = sp.pack_windows(*sp.conv_window_rulebook_batch(
        SHAPE, out_co, kernel, stride, pad, lookup))
    inv = sp.strided_inverse_rulebook_batch(co, kernel, stride, pad,
                                            out_lookup, oshape)
    assert inv is not None
    inverse = (sp.pack_inverse(*inv), sp._as3(kernel), sp._as3(stride))
    out_i, gf_i, gw_i = _grads(
        lambda a, b: window_conv(a, packed, b, False, inverse), f, w)
    out_f, gf_f, gw_f = _grads(
        lambda a, b: window_conv(a, packed, b, False), f, w)
    close(out_i.numpy(), out_f, TOL)
    assert rel_l2(gf_i, gf_f) <= TOL and rel_l2(gw_i, gw_f) <= TOL


# ---------------------------------------------------------------------------
# deep grids: lookups and rulebooks
# ---------------------------------------------------------------------------

def test_dense_table_and_deep_rulebooks_equal_jax(rng):
    """At depth 81 stage_lookup_batch takes the dense table (equal to
    JAX's, sample by sample), and the window builders give the flat
    rulebooks JAX's give; out-of-range and padded queries included."""
    _, co = voxel_batch(rng, 2, 90, 96, 1, DEEP)
    order, tco, lookup = sp.stage_lookup_batch(torch.from_numpy(co), DEEP)
    jorder, jco, jlookup = jstage_lookup(co, DEEP)
    assert lookup[0] == "dense"
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(lookup[1].numpy(), np.asarray(jlookup[1]))
    geoms = ((3, 2, 1), ((3, 1, 1), (2, 1, 1), 0))

    def jrulebooks(c, table):
        lk = ("dense", table)
        out = [jsp.subm_window_rulebook_batch(c, DEEP, 3, lk)]
        for k, s, p in geoms:
            oc, _ = jax.vmap(lambda x: jsp.conv_out_coords(
                x, DEEP, k, s, p, 120))(c)
            out.append((oc,) + jsp.conv_window_rulebook_batch(
                DEEP, oc, k, s, p, lk))
        return out

    jr = jax.jit(jrulebooks)(jco, jlookup[1])
    subm = sp.subm_window_rulebook_batch(tco, DEEP, 3, lookup)
    assert subm[1].dim() == 3 and subm[1].any()
    same_flat(subm, jr[0])
    for (k, s, p), (jout, *jdown) in zip(geoms, jr[1:]):
        out_co, oshape = sp.conv_out_coords(tco, DEEP, k, s, p, 120)
        np.testing.assert_array_equal(out_co.numpy(), np.asarray(jout))
        same_flat(sp.conv_window_rulebook_batch(DEEP, out_co, k, s, p,
                                                lookup), jdown)


def test_sorted_table_equals_jax(rng, monkeypatch):
    """With the port's dense-table threshold lowered below the grid, the
    sorted table and its binary search: ids and slots equal JAX's
    build_hash / lookup, the flat rulebook equal to the dense table's."""
    _, co = voxel_batch(rng, 2, 90, 96, 1, DEEP)
    co_t = torch.from_numpy(co)
    dense = sp.build_lookup_batch(co_t, DEEP)
    monkeypatch.setattr(sp, "_DENSE_TABLE_MAX_CELLS", 1000)
    kind, (slin, perm) = sp.build_lookup_batch(co_t, DEEP)
    assert kind == "sorted"
    q = torch.from_numpy(rng.randint(0, int(np.prod(DEEP)),
                                     (2, 300))).long()
    q[:, :50] = sp.linearize(co_t[:, :50], DEEP)        # hits
    q[:, -5:] = sp._SENTINEL
    slot, found = sp.lookup(slin, perm, q)
    for i in range(2):
        lin = jsp.linearize(jnp.asarray(co[i]), DEEP)
        js, jp = jsp.build_hash(lin)
        np.testing.assert_array_equal(slin[i].numpy(), np.asarray(js))
        jslot, jfound = jsp.lookup(js, jp, jnp.asarray(q[i].numpy(),
                                                       jnp.int32))
        np.testing.assert_array_equal(found[i].numpy(), np.asarray(jfound))
        np.testing.assert_array_equal(slot[i].numpy(), np.asarray(jslot))
        ds, dfound = sp.lookup_dense(dense[1][i:i + 1], q[i:i + 1])
        np.testing.assert_array_equal(found[i].numpy(), dfound[0].numpy())
        np.testing.assert_array_equal(slot[i].numpy(), ds[0].numpy())
    assert found[:, :50].all() and not found[:, -5:].any()
    same_flat(sp.subm_rulebook_batch(co_t, DEEP, 3, (kind, (slin, perm))),
              sp.subm_rulebook_batch(co_t, DEEP, 3, dense))


def test_deep_device_plan_is_flat_at_deep_resolutions(rng):
    """A depth-81 middle's device plan: order0 even for pre-ranked rows,
    flat rulebooks at res0 (subm) and into stage 1 (down), windows from
    stage 1's depth 41 on; host plans refuse the grid."""
    _, co = voxel_batch(rng, 1, 60, 64, 1, DEEP)
    spec = bb.middle_plan_spec(dict(pre_ranked=True, dense_tail=False),
                               DEEP_GRID, 64, host=False)
    plan = bb.build_plan_device(torch.from_numpy(co), spec, train=True)
    assert "order0" in plan
    assert isinstance(plan["s0"], sp.Flat)
    assert isinstance(plan["down1"], sp.Flat)
    for key in ("subm1", "down2", "subm2", "down3", "subm3", "down4"):
        assert torch.is_tensor(plan[key]) and plan[key].dtype == torch.int32
    assert "inv1" in plan                   # stage 1's output is a bitmap's
    with pytest.raises(ValueError, match="depths 1 to 64"):
        bb.middle_plan_spec(dict(), DEEP_GRID, 64)
