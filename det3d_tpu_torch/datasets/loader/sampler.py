"""Index samplers; port of det3d_tpu/datasets/loader/sampler.py (the same
permutation for a seed and an epoch). Parity:
det3d/datasets/loader/sampler.py:74-223.

``GroupSampler`` shuffles within flag groups, then shuffles whole
batches. The JAX package's ``DistributedGroupSampler`` waits for
distributed training (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import numpy as np


class GroupSampler:
    def __init__(self, dataset, samples_per_gpu=1, seed=0):
        self.dataset = dataset
        self.samples_per_gpu = samples_per_gpu
        self.flag = dataset.group_flag().astype(np.int64)
        self.group_sizes = np.bincount(self.flag)
        self.num_samples = 0
        for size in self.group_sizes:
            self.num_samples += int(
                np.ceil(size / samples_per_gpu)) * samples_per_gpu
        self.epoch = 0
        self.seed = seed

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        indices = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == i)[0]
            idx = idx[rng.permutation(len(idx))]
            extra = int(np.ceil(size / self.samples_per_gpu)
                        ) * self.samples_per_gpu - len(idx)
            if extra:
                idx = np.concatenate([idx, np.resize(idx, extra)])
            indices.append(idx)
        indices = np.concatenate(indices)
        # shuffle whole batches
        batches = indices.reshape(-1, self.samples_per_gpu)
        batches = batches[rng.permutation(len(batches))]
        return iter(batches.reshape(-1).tolist())
