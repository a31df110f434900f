"""The two claims the rotated-NMS kernel's design rests on, on the CPU.

(a) The cull is sound. ``csrc/rotated_nms.cu`` computes no IoU for a pair
    whose circumcircles lie apart by more than a 1e-4 relative margin (both
    areas > 0, threshold >= 0): it leaves the pair's suppression bit 0.
    ``ops/nms_cuda.py::near_pairs`` is that test in PyTorch, in the
    kernel's fp32 operations. Every pair it drops must have a plain IoU of
    exactly 0, so that 0 > thr is false at any threshold >= 0 and the keep
    mask cannot change. Held on 300k seeded near-touching pairs
    (chip_smoke.touching_pairs) and on every case chip_smoke holds the
    kernel to.
(b) The blocked scan is the greedy scan. ``blocked_scan`` below models the
    kernel's scan: per block of 64 rows, the fixpoint of kept = open &
    ~(OR of the kept rows' diagonal words), then the kept rows' later words
    ORed into ``removed``. It must equal ``greedy_suppress`` exactly.
"""

import numpy as np
import pytest
import torch

from chip_smoke import nms_cases, nms_inputs, touching_pairs
from det3d_tpu_torch.ops.nms_cuda import (greedy_suppress, near_pairs,
                                          pairwise_iou_from_corners)

torch.set_num_threads(2)

def assert_dropped_pairs_disjoint(corners, area, valid):
    """Every valid pair i < j that near_pairs drops has plain IoU exactly 0
    (both ways); returns (pairs dropped, valid pairs)."""
    iou = pairwise_iou_from_corners(corners, area)
    pair = torch.triu(valid[:, :, None] & valid[:, None, :], diagonal=1)
    dropped = pair & ~near_pairs(corners, area, valid)
    assert not bool((iou[dropped] != 0).any())
    assert not bool((iou.transpose(1, 2)[dropped] != 0).any())
    return int(dropped.sum()), int(pair.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_drops_only_disjoint_pairs(seed):
    """100k pairs of car- and pedestrian-sized boxes across KITTI's range,
    circumcircles 1e-5 to 1 m apart or overlapping by as much: the cull
    drops the pairs apart by more than its margin, and each of those has
    IoU exactly 0."""
    boxes = touching_pairs(100_000, seed, gaps=(1e-5, 1.0))
    c, a, v = nms_inputs(boxes, np.ones(boxes.shape[:2], bool), "cpu")
    dropped, pairs = assert_dropped_pairs_disjoint(c, a, v)
    assert pairs == 100_000
    assert dropped > 0.3 * pairs       # most gaps apart exceed the margin


@pytest.fixture(scope="module")
def cases():
    return nms_cases("cpu")


CASES = ("flagship N=8 K=1000", "K=333", "SECOND N=2 K=1000",
         "CBGS N=12 K=1000", "one cluster", "K=1", "K=63", "K=64", "K=65",
         "K=128", "touching", "all invalid", "duplicates", "zero-size")


@pytest.mark.parametrize("name", CASES)
def test_cull_sound_on_kernel_cases(cases, name):
    c, a, v = cases[name]
    dropped, pairs = assert_dropped_pairs_disjoint(c, a, v)
    if name == "flagship N=8 K=1000":
        # the kernel computes the IoU of ~2.6% of the pairs
        assert 0.95 * pairs < dropped < pairs


def test_cull_keeps_points_and_skips_invalid():
    """A point (area 0) keeps every pair for the full IoU, however far; an
    invalid box is in no pair."""
    boxes = np.array([[[0, 0, 1.6, 3.9, 0.3], [30, 10, 0, 0, 0],
                       [-20, 5, 1.6, 3.9, 1.0], [50, -30, 1.6, 3.9, 2.0]]],
                     np.float32)
    c, a, v = nms_inputs(boxes, np.array([[True, True, True, False]]), "cpu")
    near = near_pairs(c, a, v)[0]
    assert near[0, 1] and near[1, 2]          # the point, 30+ m away
    assert not near[0, 2]                     # two boxes 20 m apart
    assert not near[:, 3].any() and not near[3].any()


# ---------------------------------------------------------------------------
# (b) the blocked scan
# ---------------------------------------------------------------------------

FULL = (1 << 64) - 1


def blocked_scan(sup, valid):
    """The kernel's scan on one sample, in Python integers. sup: (K, K)
    bool, bit (i, j) for i < j; valid: (K,) bool. Returns keep (K,)."""
    k = len(valid)
    w_all = -(-k // 64)
    words = np.zeros((64 * w_all, w_all), object)     # row-major, as the mask
    for i, j in zip(*np.nonzero(np.triu(sup, 1))):
        words[i, j // 64] |= 1 << int(j % 64)
    removed = [0] * w_all
    keep = np.zeros(k, bool)
    for w in range(w_all):
        rows = range(64 * w, 64 * w + 64)
        invalid = sum(1 << b for b, r in enumerate(rows)
                      if r >= k or not valid[r])
        open_ = ~(removed[w] | invalid) & FULL
        kept = open_
        for _ in range(65):                   # the fixpoint, <= 64 rounds
            sup_bits = 0
            for b in range(64):
                if kept >> b & 1:
                    sup_bits |= words[64 * w + b, w]
            nxt = open_ & ~sup_bits
            if nxt == kept:
                break
            kept = nxt
        else:
            raise AssertionError("no fixpoint in 65 rounds")
        kept_rows = [b for b in range(64) if kept >> b & 1]
        for v in range(w + 1, w_all):
            for b in kept_rows:
                removed[v] |= words[64 * w + b, v]
        for b in kept_rows:
            keep[64 * w + b] = True
    return keep


@pytest.mark.parametrize("density", [0.002, 0.05, 0.5])
@pytest.mark.parametrize("k", [1, 64, 65, 1000])
def test_blocked_scan_equals_greedy(k, density):
    r = np.random.RandomState(k + int(density * 1000))
    sup = np.triu(r.uniform(size=(k, k)) < density, 1)
    valid = r.uniform(size=k) > 0.1
    # chains inside one 64-row block: each row of a run suppresses the next
    run = np.arange(min(k, 64) - 1)
    sup[run, run + 1] = True
    ref = greedy_suppress(torch.from_numpy(sup[None]).float(),
                          torch.from_numpy(valid[None]), 0.5)[0].numpy()
    np.testing.assert_array_equal(blocked_scan(sup, valid), ref)
    assert ref.sum() >= 1 or not valid.any()
