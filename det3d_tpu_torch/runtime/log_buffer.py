"""Count-weighted running averages of scalar logs; port of
det3d_tpu/runtime/log_buffer.py.
Parity: reference det3d/torchie/trainer/log_buffer.py:6-42."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class LogBuffer:
    def __init__(self):
        self.val_history = OrderedDict()
        self.n_history = OrderedDict()
        self.output = OrderedDict()
        self.ready = False

    def clear(self):
        self.val_history.clear()
        self.n_history.clear()
        self.clear_output()

    def clear_output(self):
        self.output.clear()
        self.ready = False

    def update(self, vars: dict, count: int = 1):
        for key, var in vars.items():
            self.val_history.setdefault(key, []).append(var)
            self.n_history.setdefault(key, []).append(count)

    def average(self, n: int = 0):
        """Average the latest n values, or all if n == 0.

        Values may be 0-d device tensors: they are read back HERE (once
        per log interval) rather than per iteration, so the train loop
        never waits for the card between logs."""
        for key in self.val_history:
            values = np.asarray([float(v) for v in (
                self.val_history[key][-n:] if n else
                self.val_history[key])], np.float64)
            nums = np.asarray(self.n_history[key][-n:] if n else
                              self.n_history[key], np.float64)
            self.output[key] = float((values * nums).sum() / nums.sum())
        self.ready = True
