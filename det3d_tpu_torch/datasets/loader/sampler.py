"""Index samplers; port of det3d_tpu/datasets/loader/sampler.py (the same
permutation for a seed and an epoch). Parity:
det3d/datasets/loader/sampler.py:74-223.

``GroupSampler`` shuffles within flag groups, then shuffles whole
batches; ``DistributedGroupSampler`` hands each rank a contiguous block
of that permutation, padded by wrapping so that every rank sees the same
number of batches (the reference's DistributedGroupSampler).
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


class DistributedGroupSampler(GroupSampler):
    """Rank ``rank`` of ``num_replicas``' share of GroupSampler's epoch:
    ``num_samples`` (a multiple of ``samples_per_gpu``) indices from
    offset ``num_samples * rank`` of the epoch's permutation, wrapped to
    ``num_samples * num_replicas``."""

    def __init__(self, dataset, samples_per_gpu=1, num_replicas=1, rank=0,
                 seed=0):
        super().__init__(dataset, samples_per_gpu, seed)
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_samples = int(np.ceil(
            super().__len__() / num_replicas / samples_per_gpu)
        ) * samples_per_gpu
        self.total_size = self.num_samples * num_replicas

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        indices = list(super().__iter__())
        while len(indices) < self.total_size:
            indices += indices[:self.total_size - len(indices)]
        indices = indices[:self.total_size]
        # per-rank contiguous block (reference sampler.py:205-216)
        offset = self.num_samples * self.rank
        return iter(indices[offset:offset + self.num_samples])
