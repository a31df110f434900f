"""Config helpers. Parity: det3d/utils/config_tool.py:39-48.

The port's copy of det3d_tpu/utils/config_tool.py.
"""

from __future__ import annotations

import numpy as np


def get_downsample_factor(model_config: dict) -> int:
    neck = model_config["neck"]
    ds = int(np.prod(neck.get("ds_layer_strides", [1])))
    us = neck.get("us_layer_strides", [1])
    backbone_ds = int(model_config.get("backbone", {}).get("ds_factor", 1))
    factor = ds * backbone_ds / us[-1]
    assert factor == int(factor), factor
    return int(factor)
