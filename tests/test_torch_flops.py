"""utils/flops.py and the ``flops`` subcommand on the CPU: the port's
counts against an analytic count and against XLA's cost analysis of the
JAX package's same stages.

- The small flagship's RPN and head stages: the port's count equals the
  analytic one exactly (integers: 2 Cin Cout for each (output, tap) pair
  that reads an in-bounds input, the transposed conv's every product).
- XLA's ``cost_analysis()["flops"]`` of the JAX package's neck and head
  (compiled as tools/get_flops.py:78-81 compiles each stage) lies in
  [port, port x 1.01]: XLA also counts the elementwise work (BN, ReLU,
  bias; ELEMENTWISE_SHARE below states the measured share), the port
  counts only the convolutions and products.
- A window conv's count equals 2 Cin Cout x the taps that read a row,
  counted in numpy from the plan's words; the count does not change when
  the plain twin that runs on the CPU does no aten work at all.
- The NMS kernel's count is its rule on its inputs.
- ``python -m det3d_tpu_torch.cli flops CONFIG --device cpu`` runs.
"""

import numpy as np
import pytest
import torch

import jax

from __graft_entry__ import _build_flagship
from det3d_tpu.parallel.train import build_example as jbuild_example
from det3d_tpu.utils.synth import structured_batch as jstructured_batch
from det3d_tpu_torch.apis.flagship import flagship_config
from det3d_tpu_torch.apis.train import build_stack
from det3d_tpu_torch.models.builder import init_weights
from det3d_tpu_torch.ops import window_conv_cuda as wc
from det3d_tpu_torch.ops.nms_cuda import rotated_nms_keep
from det3d_tpu_torch.parallel.predict import make_predict_step
from det3d_tpu_torch.utils import flops
from det3d_tpu_torch.utils.synth import structured_batch
from tests.test_torch_modules import PC, SMALL
from tests.test_torch_sparse_backward import small_plan

torch.set_num_threads(2)

# XLA's elementwise flops over the port's conv flops: the neck's BN and
# ReLU, the head's bias adds (measured on the CPU: neck 9.239e-03 of
# 443404288, head 7.812e-03 of 16384000)
ELEMENTWISE_SHARE = 0.01


def pairs(length, k, s, p):
    """(output, tap) pairs of a conv along one dim that read an in-bounds
    input, by enumeration."""
    out = (length + 2 * p - k) // s + 1
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * s - p + j < length)


def analytic_small_flagship(b):
    """The small flagship's RPN and head, 2 x multiply-adds, in closed
    form over its config (80 x 80 map; RPN 32-32 at stride 1 and 32-64 at
    stride 2, a 1x1 branch and a 2x2 / 2 transposed branch; the head's
    1x1 box, class and direction convs over 64 channels)."""
    h = w = 80
    neck = 0
    for cin, cout, s, n_conv, hw in ((32, 32, 1, 1, h), (32, 64, 2, 1, h)):
        neck += 2 * b * cin * cout * pairs(hw, 3, s, 1) ** 2     # down
        ho = (hw + 2 - 3) // s + 1
        neck += n_conv * 2 * b * cout * cout * pairs(ho, 3, 1, 1) ** 2
    neck += 2 * b * 32 * 32 * h * w                   # 1x1 branch
    neck += 2 * b * 64 * 32 * (h // 2) * (w // 2) * 4  # 2x2 / 2 deconv
    head = 2 * b * 64 * (14 + 2 + 4) * h * w
    return neck, head


@pytest.fixture(scope="module")
def small():
    """The small flagship in the port at random weights, one structured
    scan, and its count by stage."""
    model, vg, asg, cids, test_cfg = build_stack(
        flagship_config(small=True, **SMALL), device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    batch = structured_batch(1, 4000, PC, seed=3)
    step = make_predict_step(model, vg, asg, cids, test_cfg)
    return model, step, batch, flops.count_step(lambda: step(batch), model)


def test_rpn_and_head_counts_equal_the_analytic_count(small):
    counter = small[3]
    neck, head = analytic_small_flagship(1)
    assert counter.stages["neck"]["flops"] == neck
    assert counter.stages["bbox_head"]["flops"] == head
    assert list(counter.stages) == list(flops.STAGES)
    assert counter.stages["decode+nms"]["kernel_flops"] > 0
    assert counter.by_kernel == {"rotated_nms_keep": 1}


def test_xla_cost_analysis_of_the_same_stages(small):
    """tools/get_flops.py's per-stage cost analysis of the JAX neck and
    head at the same shapes: within [port, port x (1 + ELEMENTWISE_SHARE)]."""
    counter = small[3]
    jm, jvg, _, _ = _build_flagship(small=True, **SMALL)
    ex = jbuild_example(jstructured_batch(1, 4000, PC, seed=3), jvg, [], [],
                        with_targets=False)
    v = jax.jit(lambda e: jm.init(jax.random.PRNGKey(0), e["voxels"],
                                  e["num_points_per_voxel"],
                                  e["coordinates"], train=False))(ex)
    x = jax.numpy.zeros((1, 80, 80, 32), jax.numpy.float32)

    def cost(f, *a):
        c = jax.jit(f).lower(*a).compile().cost_analysis()
        return (c[0] if isinstance(c, list) else c)["flops"]

    neck_x = cost(lambda v_, x_: jm.apply(v_, x_, method=lambda m, y: m.neck(
        y, train=False)), v, x)
    head_x = cost(lambda v_, y_: jm.apply(v_, y_, method=lambda m, y: (
        m.bbox_head(y, train=False))), v,
        jax.numpy.zeros((1, 80, 80, 64), jax.numpy.float32))
    for name, xla in (("neck", neck_x), ("bbox_head", head_x)):
        port = counter.stages[name]["flops"]
        assert port <= xla <= port * (1 + ELEMENTWISE_SHARE), (name, xla,
                                                               port)


def test_window_conv_count_equals_taps_from_the_words(monkeypatch):
    """Each conv of a training plan (subm with the center column by rank
    shifts, strided, the z conv): the count equals 2 Cin Cout x the taps
    that read a row, counted in numpy from the packed words, and stays the
    same when the plain twin does no aten work."""
    plan = small_plan(seed=2)
    v = plan["s0"].shape[1]
    cases = [("s0", v, 4, 16, True), ("down1", v, 16, 32, False),
             ("down4", plan["co3"].shape[1], 64, 64, False)]
    for name, rows, cin, cout, subm in cases:
        words = plan[name].numpy().astype(np.int64)
        kz = 3
        r0 = np.minimum(words & 0xFFFFFF, rows - 1)
        pres = (words[..., None] >> (24 + np.arange(kz))) & 1
        row = r0[..., None] + np.cumsum(pres, -1) - pres
        if subm:
            k = words.shape[-1] // 2
            row[:, :, k] = (np.arange(words.shape[1])[:, None] - 1
                            + np.arange(kz))
        taps = int(((pres == 1) & (row >= 0) & (row < rows)).sum())
        x = torch.randn(2, rows, cin)
        w = torch.randn(kz * words.shape[-1], cin, cout)
        with flops.FlopCounter() as c:
            wc.window_conv(x, plan[name], w, subm)
        assert c.totals()["flops"] == 2 * cin * cout * taps == \
            c.totals()["kernel_flops"]
        with monkeypatch.context() as m:
            m.setattr(wc, "window_conv_ref",
                      lambda f, r0_, p_, w_, cs: torch.zeros(
                          f.shape[0], r0_.shape[1], w_.shape[-1]))
            with flops.FlopCounter() as bare:
                wc.window_conv(x, plan[name], w, subm)
        assert bare.totals() == c.totals()


def test_nms_count_is_its_rule(rng):
    boxes = rng.uniform(0, 20, (2, 64, 8)).astype(np.float32)
    corners = torch.from_numpy(boxes)
    area = torch.ones(2, 64)
    valid = torch.from_numpy(rng.uniform(size=(2, 64)) > 0.3)
    with flops.FlopCounter() as c:
        rotated_nms_keep(corners, area, valid, 0.5)
    nbytes, want = flops.nms_work(corners, area, valid)
    assert c.totals()["flops"] == want == c.totals()["kernel_flops"]
    assert c.totals()["bytes"] == nbytes


def test_flops_subcommand_on_the_cpu(capsys):
    from det3d_tpu_torch.cli import main
    assert main(["flops", "configs/smoke_kitti_pointpillars.py", "--device",
                 "cpu", "--points", "2000"]) == 0
    out = capsys.readouterr().out
    for stage in flops.STAGES + ("predict",):
        assert f"\n{stage} " in out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["flops", "configs/smoke_kitti_pointpillars.py"])
