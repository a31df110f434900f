"""Operation and byte counts, and the card's peaks, frozen.

Copied from det3d_tpu_torch/utils/flops.py (``peak_of``, ``bound``,
``conv_work``, ``inverse_work``, ``nms_bound`` and its constants) and
chip_smoke.py (``bwd_work``), and applied to the reference's own count of
a layer's work (reference/voxelnet.py: each conv's active output rows,
active input rows and the (output, tap) pairs that read an active input)
instead of the program's rulebooks: the counts are of the useful work on
the cell's inputs, and read the same whatever implements a step. The
plan words a kernel also reads are left out of its bytes, which only
lowers the bound of the bytes-bound stems.

Peaks: NVIDIA H100 SXM 80 GB at its 700 W limit, dense rates: fp32 67
TFLOP/s outside the tensor cores, bf16 989 TFLOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BPS = 3.35e12
NMS_FLOPS_PER_PAIR = 250        # ~ fp32 operations of one pair IoU
NMS_FLOPS_PER_TEST = 10         # ~ fp32 operations of one circumcircle test


def peak_of(dtype: str) -> float:
    return BF16_FLOPS if dtype in ("bf16", "fp16") else FP32_FLOPS


def bound(nbytes: float, flops: float, peak: float) -> float:
    """Seconds: the larger of the bytes over HBM and the operations over
    the peak."""
    return max(nbytes / HBM_BPS, flops / peak)


def conv_work(w: dict, elt: int = 4):
    """(bytes, flops) of a sparse conv's forward: the active input rows
    read once, the weights read once, the output rows written once (fp32);
    2 Cin Cout a pair."""
    nbytes = (w["rows_in"] * w["cin"] * elt + w["kvol"] * w["cin"]
              * w["cout"] * elt + w["rows_out"] * w["cout"] * 4)
    return nbytes, w["flops"]


def bwd_work(w: dict):
    """{"dw": (bytes, flops), "dx": (bytes, flops)} of a sparse conv's
    backward (chip_smoke.py::bwd_work): dW reads what the forward reads
    and dY and writes dW; dX (the subm's mirrored forward, or a strided
    conv's inverse) reads dY and the weights and writes dX; both do the
    forward's products."""
    nbytes, flops = conv_work(w)
    dx = (w["rows_out"] * w["cout"] * 4 + w["kvol"] * w["cin"] * w["cout"]
          * 4 + w["rows_in"] * w["cin"] * 4)
    return {"dw": (nbytes, flops), "dx": (dx, flops)}


def nms_work(valid: int, near: int, slots: int):
    """(bytes, flops) of one rotated NMS keep problem (nms_bound's rule):
    a circumcircle test for every pair of valid boxes, a full IoU for the
    pairs whose circles meet; corners, area and the valid flag of each
    slot read once, the keep flag written once."""
    pairs = valid * (valid - 1) / 2
    nbytes = slots * (8 * 4 + 4 + 1) + slots
    return nbytes, pairs * NMS_FLOPS_PER_TEST + near * NMS_FLOPS_PER_PAIR


def step_flops(work, train: bool) -> float:
    """The operations of a step: the forward's products, and in training
    twice as many more for dX and dW, less the first layer's dX (its
    input, the voxel means, takes no gradient)."""
    f = sum(w["flops"] for w in work)
    if not train:
        return f
    return 3 * f - (work[0]["flops"] if work else 0.0)
