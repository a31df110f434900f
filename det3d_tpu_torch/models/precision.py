"""Mixed-precision helper: config string -> activation dtype.

Port of det3d_tpu/models/precision.py. Modules take ``precision: str``
("fp32" | "bf16"); bf16 means bf16 activations, with fp32 parameters cast
to bf16 for each call, fp32 accumulation in the convolutions and GEMMs,
and BatchNorm that normalizes in fp32 and rounds its output to bf16. Heads
cast their outputs back to fp32 for decode and NMS.
"""

import torch

_MAP = {"fp32": torch.float32, "float32": torch.float32,
        "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def act_dtype(precision: str) -> torch.dtype:
    """The activation dtype of ``precision``; any other string raises
    rather than quietly running fp32."""
    try:
        return _MAP[str(precision).lower()]
    except KeyError:
        raise NotImplementedError(
            f"precision={precision!r} is not served (fp32 or bf16)") from None
