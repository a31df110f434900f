"""The claims the fp32 window-conv kernel's design rests on, on the CPU.

``csrc/window_conv.cu``'s fp32 kernel lists, per tile of output rows, the
taps that any row of the tile has, and lets each warp skip a listed tap
that no row of its band of rows reads. ``ops/window_conv_cuda.py::
f32_schedule`` models that schedule in PyTorch with the kernel's tile and
band geometry (a ``cuda`` test holds the geometry to the kernel's own
constants). Held here:

(a) The skip is sound: every (o, k, j) that reads an input row, as
    ``chip_smoke.tap_rows`` (the plain version's rules) selects it, is run
    by the warp whose band holds row o, and every tap a warp runs is
    listed for its tile. On SECOND's and CBGS's host plans at full scale,
    a Lyft plan cut to +-12.8 m (each with its dense tail's rulebooks,
    built as the tail builds them: ``chip_smoke.tail_plan``), CBGS's
    middle without its dense tail (the 128-channel layers), an all-absent
    plan, one row, and O at the tile and band edges.
(b) The yardstick is the function: chip_smoke's im2col+matmul, which
    times the same conv as one gather and one matmul, equals the plain
    version in fp32 within rtol = atol = 1e-4 at every (Cin, Cout,
    center_shift) of SECOND's and CBGS's middles and at Cout 128.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from det3d_tpu_torch.ops.sparse import unpack_windows
from det3d_tpu_torch.ops.window_conv_cuda import (F32_GEOMETRY, f32_schedule,
                                                  window_conv_ref)

torch.set_num_threads(2)


def check_schedule(packed, v, center_shift, cout):
    """(a) on one rulebook; returns the schedule."""
    pk = torch.as_tensor(packed)
    sch = f32_schedule(pk, v, center_shift, cout)
    tile, band = F32_GEOMETRY[cout]
    assert (sch["tile"], sch["band"]) == (tile, band)
    _, sel = cs.tap_rows(pk, v, center_shift)
    bi, oi, ki, ji = torch.nonzero(sel, as_tuple=True)
    assert bool(sch["runs"][bi, oi // tile, (oi % tile) // band, ki,
                            ji].all())
    assert bool((sch["listed"][:, :, None] | ~sch["runs"]).all())
    assert sch["useful"] == int(sel.sum())
    # listed: exactly the taps with a presence bit in some row of the tile
    _, pres = unpack_windows(pk, 3)
    t = -(-pk.shape[1] // tile)
    padded = torch.zeros(pk.shape[0], t * tile, *pres.shape[2:], dtype=bool)
    padded[:, :pk.shape[1]] = pres
    assert torch.equal(sch["listed"],
                       padded.view(pk.shape[0], t, tile,
                                   *pres.shape[2:]).any(2))
    assert sch["useful"] <= sch["executed"] <= (
        int(sch["listed"].sum()) * tile)
    return sch


def layer_plans(plan, layers, cfg=None):
    """{(plan key, Cout, center_shift): (packed, V)} over a middle's
    window convs in forward order; with ``cfg``, its dense tail's on the
    rulebooks the tail builds on ``plan``."""
    if cfg is not None:
        plan = dict(plan, **cs.tail_plan(cs.detector_of(cfg), plan, "cpu"))
    out, rows = {}, plan["plan_s0"].shape[1]
    for key, _, cout, subm in layers:
        pk = plan[f"plan_{key}"]
        out[key, cout, subm] = (pk, rows)
        rows = pk.shape[1]
    return out


@pytest.fixture(scope="module")
def plans():
    """The host plans of one scan: SECOND and CBGS as shipped at full
    scale, Lyft cut to +-12.8 m, CBGS without its dense tail."""
    from det3d_tpu_torch.utils.synth import structured_batch
    sec = cs.second_config()
    batch = structured_batch(1, cs.POINTS, sec["voxel_generator"]["range"],
                             seed=cs.SEED)
    out = {"second": layer_plans(cs.plan_builder(sec)(
        batch["points"], batch["num_points"]), cs.SECOND_LAYERS, sec)}
    cbgs = cs.cbgs_config()
    scan = cs.cbgs_batch(1, cs.CBGS_POINTS, cbgs["voxel_generator"]["range"])
    out["cbgs"] = layer_plans(cs.plan_builder(cbgs)(
        scan["points"], scan["num_points"]), cs.CBGS_LAYERS, cbgs)
    no_tail = cs.cbgs_variant((2, False))
    layers = cs.cbgs_variant_layers((2, False))
    out["cbgs no tail"] = {
        key: val for key, val in layer_plans(cs.plan_builder(no_tail)(
            scan["points"], scan["num_points"]), layers).items()
        if key[1] == 128}
    lyft = cs.LYFT.scans(1, cs.LYFT.cut[2], cut=True)
    lcfg = cs.LYFT.config(cut=True)
    out["lyft cut"] = layer_plans(cs.plan_builder(lcfg)(
        lyft["points"], lyft["num_points"]), cs.LYFT.layers, lcfg)
    return out


LAYERS = ([("second", k) for k in dict.fromkeys(
              (key, cout, subm) for key, _, cout, subm in cs.SECOND_LAYERS)]
          + [(p, k) for p in ("cbgs", "lyft cut") for k in dict.fromkeys(
              (key, cout, subm) for key, _, cout, subm in cs.CBGS_LAYERS)]
          + [("cbgs no tail", ("down3", 128, False)),
             ("cbgs no tail", ("subm3", 128, True)),
             ("cbgs no tail", ("down4", 128, False))])


@pytest.mark.parametrize("name,layer", LAYERS,
                         ids=[f"{p}-{k[0]}-{k[1]}" for p, k in LAYERS])
def test_skip_keeps_every_tap_that_reads_a_row(plans, name, layer):
    packed, v = plans[name][layer]
    sch = check_schedule(packed, v, layer[2], layer[1])
    assert sch["useful"] > 0
    # the warp skip runs fewer products than the whole tile would
    assert sch["executed"] < int(sch["listed"].sum()) * sch["tile"]


def random_words(o, v, seed, density=0.3, k=9):
    """(1, O, K) packed words: each (row, column) present with probability
    ``density``, 1-7 presence bits, r0 anywhere in [0, V + 2]."""
    r = np.random.RandomState(seed)
    r0 = r.randint(0, v + 3, size=(1, o, k))
    bits = r.randint(1, 8, size=(1, o, k)) * (r.uniform(size=(1, o, k))
                                              < density)
    return (r0 | (bits << 24)).astype(np.int32)


@pytest.mark.parametrize("cout", [16, 128])
@pytest.mark.parametrize("o", [1, 63, 64, 65, 127, 128, 129])
def test_skip_at_tile_and_band_edges(o, cout):
    """O around the 64- and 128-row tiles, sparse rows (density 0.05, so
    that some bands skip some taps), both rulebook kinds."""
    for center_shift in (True, False):
        v = o if center_shift else 97
        check_schedule(random_words(o, v, o, density=0.05), v, center_shift,
                       cout)


@pytest.mark.parametrize("center_shift", [True, False])
def test_all_absent_lists_nothing(center_shift):
    sch = check_schedule(np.zeros((2, 200, 9), np.int32), 200, center_shift,
                         32)
    assert not sch["listed"].any() and sch["executed"] == 0


@pytest.mark.parametrize("cout", [16, 32, 64, 128])
def test_one_row_runs_one_warp(cout):
    """One tap in one row: its tile lists it alone and only the warp whose
    band holds the row runs it."""
    o = v = 300
    packed = np.zeros((1, o, 9), np.int32)
    packed[0, 141, 2] = 50 | (0b010 << 24)
    sch = check_schedule(packed, v, False, cout)
    tile, band = F32_GEOMETRY[cout]
    assert int(sch["listed"].sum()) == 1 and bool(
        sch["listed"][0, 141 // tile, 2, 1])
    assert int(sch["runs"].sum()) == 1 and bool(
        sch["runs"][0, 141 // tile, (141 % tile) // band, 2, 1])
    assert sch["executed"] == band and sch["useful"] == 1


YARD_SHAPES = sorted({(cin, cout, subm) for _, cin, cout, subm in
                      cs.SECOND_LAYERS + cs.CBGS_LAYERS}
                     | {(64, 128, False), (128, 128, True)})


@pytest.mark.parametrize("cin,cout,center_shift", YARD_SHAPES)
def test_im2col_yardstick_equals_plain(cin, cout, center_shift):
    """(b): im2col_matmul in fp32 against window_conv_ref."""
    o = 160
    v = o if center_shift else 140
    pk = torch.as_tensor(random_words(o, v, cin + cout))
    r = np.random.RandomState(cin * cout)
    x = torch.as_tensor(r.randn(1, v, cin).astype(np.float32))
    w = torch.as_tensor((r.randn(27, cin, cout) / (27 * cin) ** 0.5)
                        .astype(np.float32))
    r0, pres = unpack_windows(pk, 3)
    ref = window_conv_ref(x, r0, pres, w, center_shift)
    out = cs.im2col_matmul(x, pk, w, center_shift)()
    assert ref.abs().max() > 0.1
    torch.testing.assert_close(out, ref, **cs.CONV_TOL["fp32"])
