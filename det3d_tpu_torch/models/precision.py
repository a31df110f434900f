"""Mixed-precision helper: config string -> activation dtype.

Port of det3d_tpu/models/precision.py. Modules take ``precision: str``
("fp32" | "bf16"); bf16 means bf16 activations and weights with fp32
parameters, fp32 accumulation and fp32 BatchNorm statistics.
"""

import torch

_MAP = {"fp32": torch.float32, "float32": torch.float32,
        "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def act_dtype(precision: str) -> torch.dtype:
    return _MAP[str(precision).lower()]
