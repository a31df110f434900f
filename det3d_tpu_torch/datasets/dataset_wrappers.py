"""Concat / Repeat wrappers; port of det3d_tpu/datasets/dataset_wrappers.py.
Parity: det3d/datasets/dataset_wrappers.py:8-55."""

from __future__ import annotations

import numpy as np


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cumulative_sizes[ds - 1])
        return self.datasets[ds][idx - prev]

    def group_flag(self):
        return np.concatenate([d.group_flag() for d in self.datasets])

    def evaluation(self, detections, output_dir):
        return self.datasets[0].evaluation(detections, output_dir)


class RepeatDataset:
    def __init__(self, dataset, times):
        self.dataset = dataset
        self.times = times
        self._len = times * len(dataset)

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]

    def group_flag(self):
        return np.tile(self.dataset.group_flag(), self.times)

    def evaluation(self, detections, output_dir):
        return self.dataset.evaluation(detections, output_dir)
