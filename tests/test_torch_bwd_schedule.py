"""The schedules of the window conv's backward kernels
(det3d_tpu_torch/csrc/window_conv_bwd.cu), modelled on the CPU by
det3d_tpu_torch/ops/window_conv_cuda.py, held to the JAX package's
training plans and to its backward (``_window_conv_dw``,
``_strided_inverse_df``).

- dW: ``dw_grid`` lists every tap once (a submanifold conv's center tap
  first, over DW_CENTER_SPLIT grid rows), ``dw_chunk_rows`` cuts the B*O
  output rows of each tap into its chunks once each, in row order, and
  the sum that schedule gives (each chunk in row order, the chunks in
  chunk order) equals JAX's dW at every conv of cut SECOND and CBGS
  training plans; the schedule is a function of the shapes alone: two
  plans of one shape take one schedule.
- Inverse dX: ``inverse_classes`` equals the parities JAX's
  ``unpack_inverse`` reads (class 8: the rows with no candidate present);
  ``inverse_blocks`` gives blocks of one class each, at most RB rows in
  row order, every other row once; the dX summed block by block over the
  class's taps (``class_taps``) in tap order equals JAX's
  ``_strided_inverse_df``.
- The geometries (``dw_geometry``, ``inv_geometry``) fit a block of the
  H100 at every width the wrappers take.

tests/test_torch_kernels_cuda.py holds these models equal to the kernels'
own on the card.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from det3d_tpu.apis.train import build_stack as jbuild_stack
from det3d_tpu.apis.train import host_plan_fn as jhost_plan_fn
from det3d_tpu.ops import sparse as jsp
from det3d_tpu_torch.ops import sparse as sp
from det3d_tpu_torch.ops import window_conv_cuda as wc
from det3d_tpu_torch.utils.flops import tap_rows
from tests.test_torch_sparse_backward import (CONFIGS, CONV_REL, cut_config,
                                              rel_l2, scans)

torch.set_num_threads(2)

# the convs of the cut SECOND (dense tail from stage 3) and CBGS (dense
# from stage 2) middles: (plan key, center_shift, Cin, Cout)
LAYERS = {"second": (("s0", True, 4, 16), ("down1", False, 16, 32),
                     ("subm1", True, 32, 32), ("down2", False, 32, 64),
                     ("subm2", True, 64, 64), ("down3", False, 64, 64)),
          "cbgs": (("s0", True, 5, 16), ("down1", False, 16, 32),
                   ("subm1", True, 32, 32), ("down2", False, 32, 64))}
CASES = [(key, layer) for key in LAYERS for layer in LAYERS[key]]


def jax_plan(key, seed=5):
    """JAX's host training plan of ``scans(key)`` (another draw of the
    same shapes with ``seed``)."""
    s = scans(key)
    if seed != 5:
        s = cs.sparse_train_scene("cbgs" if key == "cbgs" else "second", 2,
                                  cut_config(CONFIGS[key][0])[
                                      "voxel_generator"]["range"], 3000,
                                  seed=seed)
        s["num_points"][1] = 150
    cfg = cut_config(*CONFIGS[key][:1], **CONFIGS[key][1])
    jm, jvg = jbuild_stack(copy.deepcopy(cfg))[:2]
    plan = jhost_plan_fn(jm, jvg, train=True)(s["points"], s["num_points"])
    return {k: np.asarray(v) for k, v in plan.items()}


@pytest.fixture(scope="module")
def plans():
    return {key: jax_plan(key) for key in LAYERS}


def layer_inputs(plan, key, cin, cout, seed):
    """Seeded features of the layer's input rows and dy of its outputs."""
    packed = torch.from_numpy(plan[f"plan_{key}"])
    b, o, k = packed.shape
    v = (o if key.startswith(("s0", "subm")) else
         plan[f"plan_inv{key[4:]}"].shape[1])
    rng = np.random.RandomState(seed)
    x = rng.randn(b, v, cin).astype(np.float32)
    dy = (rng.randn(b, o, cout) / np.sqrt(b * o)).astype(np.float32)
    return packed, x, dy


def dw_by_schedule(x, packed, dy, center_shift, kz=3):
    """dW as the kernels sum it: for each grid row's chunks of a tap, the
    chunk's rows in row order, then the tap's chunks in chunk order.
    Also returns, per tap, the rows its chunks covered, in chunk order."""
    b, v, cin = x.shape
    o, k = packed.shape[1:]
    kvol, cout = kz * k, dy.shape[-1]
    rows, sel = tap_rows(packed, v, center_shift, kz)     # (B, O, K, kz)
    xf = torch.cat([x, x.new_zeros(b, 1, cin)], 1)
    flat = dy.reshape(b * o, cout)
    nch = wc.dw_chunks(b * o, kvol)
    parts = {}
    for tap, chunks, first in wc.dw_grid(kvol, k, center_shift, nch):
        j, kk = divmod(tap, k)
        src = torch.where(sel[..., kk, j], rows[..., kk, j], v)   # (B, O)
        gathered = torch.gather(xf, 1, src[..., None].expand(b, o, cin))
        gathered = gathered.reshape(b * o, cin)
        for c in range(first, first + nch):
            r = wc.dw_chunk_rows(b * o, chunks, c)
            parts.setdefault(tap, []).append(
                (c, r, gathered[r].T @ flat[r]))
    dw = torch.zeros(kvol, cin, cout)
    covered = {}
    for tap, ps in parts.items():
        ps.sort(key=lambda p: p[0])
        for _, _, part in ps:
            dw[tap] += part
        covered[tap] = [p[1] for p in ps]
    return dw, covered


@pytest.mark.parametrize("key,layer", CASES,
                         ids=[f"{k}-{l[0]}-{l[2]}x{l[3]}" for k, l in CASES])
def test_dw_schedule_equals_jax(plans, key, layer):
    name, center_shift, cin, cout = layer
    packed, x, dy = layer_inputs(plans[key], name, cin, cout, cin + cout)
    dw, covered = dw_by_schedule(torch.from_numpy(x), packed,
                                 torch.from_numpy(dy), center_shift)
    b, o, k = packed.shape
    assert sorted(covered) == list(range(3 * k))
    for tap, rows in covered.items():
        # each row once, in order within a chunk
        assert all(bool((r[1:] > r[:-1]).all()) for r in rows)
        assert torch.equal(torch.sort(torch.cat(rows))[0],
                           torch.arange(b * o)), tap
    r0, pres = (jnp.asarray(a.numpy()) for a in sp.unpack_windows(packed, 3))
    ref = jsp._window_conv_dw(jnp.asarray(x), r0, pres, jnp.asarray(dy),
                              center_shift)
    assert rel_l2(dw.numpy(), np.asarray(ref)) <= CONV_REL


@pytest.mark.parametrize("k,kz,center_shift", [
    (9, 3, True), (9, 3, False), (1, 3, False), (9, 7, False),
    (9, 1, False)])
def test_dw_grid_lists_every_tap_heaviest_first(k, kz, center_shift):
    """Every tap on a grid row, the center tap first (split over
    DW_CENTER_SPLIT rows of a submanifold conv), then the center's z
    level, then the rest in tap order; the rows of one tap's chunks
    cover its chunk indices once."""
    kvol = k * kz
    grid = wc.dw_grid(kvol, k, center_shift, 5)
    split = wc.DW_CENTER_SPLIT if center_shift else 1
    tc = (kz // 2) * k + k // 2
    assert len(grid) == kvol + split - 1
    assert [t for t, _, _ in grid[:split]] == [tc] * split
    assert sorted({t for t, _, _ in grid}) == list(range(kvol))
    level = [t for t, _, _ in grid[split:split + k - 1]]
    assert all(t // k == kz // 2 for t in level)
    rest = [t for t, _, _ in grid[split + k - 1:]]
    assert rest == sorted(rest)
    firsts = [f for t, n, f in grid if t == tc]
    assert firsts == [5 * y for y in range(split)]
    assert all(n == 5 * split for t, n, _ in grid if t == tc)


def test_dw_schedule_depends_on_shapes_alone(plans):
    """Another draw of SECOND's cut scans plans the same shapes: the same
    chunks, grid and geometry, and the schedule's dW still JAX's."""
    other = jax_plan("second", seed=11)
    for name, center_shift, cin, cout in LAYERS["second"]:
        a, b = plans["second"][f"plan_{name}"], other[f"plan_{name}"]
        assert a.shape == b.shape and not np.array_equal(a, b)
        bo, k = a.shape[0] * a.shape[1], a.shape[2]
        assert wc.dw_chunks(bo, 3 * k) == wc.dw_chunks(b.shape[0]
                                                       * b.shape[1], 3 * k)
        assert wc.dw_geometry(cin, cout, center_shift) == wc.dw_geometry(
            cin, cout, center_shift)
    packed, x, dy = layer_inputs(other, "subm2", 64, 64, 3)
    dw, _ = dw_by_schedule(torch.from_numpy(x), packed,
                           torch.from_numpy(dy), True)
    r0, pres = (jnp.asarray(q.numpy()) for q in sp.unpack_windows(packed, 3))
    ref = jsp._window_conv_dw(jnp.asarray(x), r0, pres, jnp.asarray(dy),
                              True)
    assert rel_l2(dw.numpy(), np.asarray(ref)) <= CONV_REL


def test_dw_chunks_cut_rows_once():
    """At the paths' row counts and taps: chunks between one and a tile
    each, every tile in one chunk, the chunks' tiles strided."""
    for rows in (1, 255, 1024, 80000, 120000, 160000):
        for kvol in (3, 27, 63):
            n = wc.dw_chunks(rows, kvol)
            tiles = -(-rows // wc.DW_TILE)
            assert 1 <= n <= tiles
            got = torch.cat([wc.dw_chunk_rows(rows, n, c) for c in range(n)])
            assert torch.equal(torch.sort(got)[0], torch.arange(rows))
            first = wc.dw_chunk_rows(rows, n, 0)
            assert bool((first // wc.DW_TILE % n == 0).all())


# ---------------------------------------------------------------------------
# the inverse dX
# ---------------------------------------------------------------------------

INV = [(key, name, cin, cout) for key in LAYERS
       for name, cs_, cin, cout in LAYERS[key] if not cs_]


def jax_inverse(plan, name):
    inv = plan[f"plan_inv{name[4:]}"]
    kspec = ((3, 3, 3), (2, 2, 2), sp.ncand_of((3, 3, 3), (2, 2, 2)))
    return inv, jsp.unpack_inverse(jnp.asarray(inv), kspec)


@pytest.mark.parametrize("key,name,cin,cout", INV)
def test_inverse_classes_equal_jax_parities(plans, key, name, cin, cout):
    inv, (_, presi, par, _) = jax_inverse(plans[key], name)
    got = wc.inverse_classes(torch.from_numpy(inv), 2).numpy()
    par = np.asarray(par)
    want = par[..., 0] + 2 * par[..., 1] + 4 * par[..., 2]
    empty = ~np.asarray(presi).any(axis=(-1, -2))
    want = np.where(empty, 8, want)
    np.testing.assert_array_equal(got, want)
    assert empty.any() and (~empty).any()


@pytest.mark.parametrize("key,name,cin,cout", INV)
def test_inverse_blocks_equal_jax_dx(plans, key, name, cin, cout):
    """The blocks: one class each, rows ascending, at most RB, the classes
    in turn, every row with a candidate once; the dX summed block by block
    over the class's taps in tap order equals JAX's."""
    inv, (jr0i, jpresi, jpar, kspec) = jax_inverse(plans[key], name)
    k3, s3 = (3, 3, 3), (2, 2, 2)
    b, v, kc = inv.shape
    packed = plans[key][f"plan_{name}"]
    o = packed.shape[1]
    rng = np.random.RandomState(cin * cout)
    dy = rng.randn(b, o, cout).astype(np.float32)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    geo = wc.inv_geometry(cin, cout)
    blocks = wc.inverse_blocks(torch.from_numpy(inv), 2, geo["rb"])
    cls = wc.inverse_classes(torch.from_numpy(inv), 2).reshape(-1)
    assert [c for c, _ in blocks] == sorted(c for c, _ in blocks)
    for c in range(8):
        rows = [r for cc, r in blocks if cc == c]
        assert all(0 < len(r) <= geo["rb"] for r in rows)
        got = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.long)
        assert torch.equal(got, torch.nonzero(cls == c).reshape(-1))
    # dX block by block, each class's taps in tap order
    r0i, presi, par = sp.unpack_inverse(torch.from_numpy(inv), 2)
    rowsel = [sp._window_taps(torch.cat([torch.from_numpy(dy),
                                         torch.zeros(b, 1, cout)], 1),
                              torch.clamp(r0i[:, :, ci], max=o - 1),
                              presi[:, :, ci]) for ci in range(kc)]
    dx = torch.zeros(b * v, cin)
    wt = torch.from_numpy(w)
    for c, rows in blocks:
        acc = torch.zeros(len(rows), cin)
        for kk in wc.class_taps(c, k3, s3):
            jz, jy, jx = kk // 9, (kk // 3) % 3, kk % 3
            tap = rowsel[(jy // 2) * 2 + jx // 2][1 - jz // 2]
            acc = acc + tap.reshape(b * v, cout)[rows] @ wt[kk].T
        dx[rows] = acc
    ref = jsp._strided_inverse_df(jnp.asarray(dy), jr0i, jpresi, jpar,
                                  jnp.asarray(w), kspec)
    assert rel_l2(dx.numpy(), np.asarray(ref).reshape(b * v, cin)) <= CONV_REL


@pytest.mark.parametrize("k3,s3,want", [
    ((3, 3, 3), (2, 2, 2), (8, 4, 4, 2, 4, 2, 2, 1)),
    ((3, 1, 1), (2, 1, 1), (2, 1, 0, 0, 0, 0, 0, 0)),
    ((1, 1, 1), (2, 2, 2), (1, 0, 0, 0, 0, 0, 0, 0))])
def test_class_taps(k3, s3, want):
    """Taps a class takes: j mod s equal to the class's parity per dim;
    each tap in exactly one class; at most INV_MAX_TAPS."""
    got = [wc.class_taps(c, k3, s3) for c in range(8)]
    assert tuple(map(len, got)) == want
    assert sorted(t for ts in got for t in ts) == list(range(np.prod(k3)))
    assert max(want) <= wc.INV_MAX_TAPS


# ---------------------------------------------------------------------------
# the geometries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cout", [4, 8, 12, 16, 20, 32, 64, 96, 128])
def test_dw_geometry_fits_every_width(cout):
    for cin in range(1, 129):
        for cs_ in (True, False):
            g = wc.dw_geometry(cin, cout, cs_)
            assert g["team"] == -(-cin // g["tm"]) * -(-cout // g["tn"])
            assert 1 <= g["slices"] and g["slices"] * g["team"] <= 256
            assert g["pairs"] >= wc.DW_MIN_PAIRS
            assert g["lx"] >= cin and g["lx"] % 4 == 0
            assert g["ly"] >= cout and g["ly"] % 4 == 0
            assert g["smem"] <= wc._MAX_SMEM


@pytest.mark.parametrize("cout", [4, 8, 16, 32, 64, 128])
def test_inv_geometry_fits_every_width(cout):
    for cin in range(4, 129, 4):
        g = wc.inv_geometry(cin, cout)
        assert g is not None, (cin, cout)
        assert g["nci"] == cin // 4 and g["nr"] * g["nci"] <= 256
        assert g["rb"] == g["nr"] * g["tm"] <= wc.INV_MAX_ROWS
        assert g["smem"] <= wc._MAX_SMEM
