"""Batched data loader with persistent fork workers.

Port of det3d_tpu/datasets/loader/loader.py, which replaces
torch.utils.data.DataLoader + collate_kitti (reference:
datasets/loader/build_loader.py:23-57, torchie/parallel/collate.py:90-160).
The pipeline's Reformat stage pads every example to fixed shapes, so
collation is a plain np.stack and the metadata stay lists.

Workers are fork()ed once (persistent across epochs) and seeded
``seed * 1000 + w``, as the JAX package's are. Unlike its workers, which
take index chunks from one shared queue (so which worker's random stream
draws a batch depends on timing), batch ``i`` of every pass goes to worker
``i % num_workers``, each worker over its own task queue: the batches of a
seed are the same in every run. ``replay`` computes them in-process, the
plain version of the workers that the tests and chip_smoke.py hold them
to. ``num_workers=0`` runs in-process on the global ``np.random``, as the
JAX package's loader does.

The workers run numpy and the C++ of csrc/ through ctypes, never torch:
the parent may have initialized CUDA and torch's thread pools before it
forks, and a forked child that touches either can hang. The parent loads
the native libraries before it forks, so that no worker builds them.
"""

from __future__ import annotations

import copy
import multiprocessing as mp
from typing import Any, Dict, List

import numpy as np

from det3d_tpu_torch import csrc
from det3d_tpu_torch.datasets.loader.sampler import GroupSampler


def collate(examples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack fixed-shape example dicts; non-array leaves become lists."""
    out: Dict[str, Any] = {}
    for k in examples[0]:
        vals = [e[k] for e in examples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]) \
                or isinstance(vals[0], (np.integer, np.floating)):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def worker_seed(seed: int, w: int) -> int:
    """The np.random seed of worker ``w``."""
    return seed * 1000 + w


def _worker_loop(dataset, task_q, result_q, seed):
    np.random.seed(seed)
    while True:
        task = task_q.get()
        if task is None:
            break
        batch_id, indices = task
        try:
            examples = [dataset[i] for i in indices]
            result_q.put((batch_id, collate(examples), None))
        except Exception:  # surface worker errors to the main process
            import traceback
            result_q.put((batch_id, None, traceback.format_exc()))


class DataLoader:
    def __init__(self, dataset, batch_size=1, sampler=None, shuffle=False,
                 num_workers=0, drop_last=True, seed=0):
        self._workers: List[Any] = []
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        if sampler is None:
            sampler = GroupSampler(dataset, batch_size, seed=seed) \
                if shuffle else None
        self.sampler = sampler

    def set_epoch(self, epoch):
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _index_batches(self):
        if self.sampler is not None:
            indices = list(iter(self.sampler))
        else:
            indices = list(range(len(self.dataset)))
        nb = len(indices) // self.batch_size
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        if not self.drop_last and nb * self.batch_size < len(indices):
            batches.append(indices[nb * self.batch_size:])
        return batches

    def __len__(self):
        return len(self._index_batches())

    def _ensure_workers(self):
        """Persistent fork workers: spawned once, fed tasks each pass.
        Respawning per epoch would add the fork and the first batch's
        latency to every epoch."""
        if self._workers:
            return
        for name in csrc.HOST_SOURCES:      # built and loaded before fork
            csrc.load(name)
        ctx = mp.get_context("fork")
        self._task_qs = [ctx.Queue() for _ in range(self.num_workers)]
        self._result_q = ctx.Queue(maxsize=max(4, self.num_workers * 2))
        for w in range(self.num_workers):
            p = ctx.Process(
                target=_worker_loop,
                args=(self.dataset, self._task_qs[w], self._result_q,
                      worker_seed(self.seed, w)),
                daemon=True)
            p.start()
            self._workers.append(p)

    def close(self):
        """Stop the workers."""
        for p in self._workers:
            p.terminate()
        for p in self._workers:
            p.join()
        self._workers = []

    def __del__(self):
        self.close()

    def __iter__(self):
        batches = self._index_batches()
        if self.num_workers == 0:
            for idxs in batches:
                yield collate([self.dataset[i] for i in idxs])
            return

        self._ensure_workers()
        for bid, idxs in enumerate(batches):
            self._task_qs[bid % self.num_workers].put((bid, idxs))
        pending: Dict[int, Any] = {}
        next_id = received = 0
        try:
            while received < len(batches):
                bid, batch, err = self._result_q.get()
                received += 1
                if err is not None:
                    raise RuntimeError(f"dataloader worker failed:\n{err}")
                pending[bid] = batch
                while next_id in pending:
                    yield pending.pop(next_id)
                    next_id += 1
        finally:
            # a pass left early: let the workers finish its batches, so
            # that their streams stand where a whole pass leaves them and
            # no result of it reaches the next pass
            for _ in range(received, len(batches) if self._workers else 0):
                self._result_q.get()


def replay(loader: DataLoader, epochs) -> List[Dict[str, Any]]:
    """The batches ``loader``'s workers give over ``epochs`` passes
    (set_epoch(e) for each e), computed in-process: worker ``w``'s share,
    batches ``w, w + W, ...`` of each pass, from its own copy of the
    dataset as it stood when the workers forked and from
    ``np.random.seed(worker_seed(seed, w))``. Restores np.random's state
    after. The plain version of the loader's workers."""
    n = loader.num_workers
    saved = np.random.get_state()
    # np.random itself (GT-AUG's sampler holds it) is shared, not copied
    copies = [copy.deepcopy(loader.dataset, {id(np.random): np.random})
              for _ in range(n)]
    states = []
    for w in range(n):
        np.random.seed(worker_seed(loader.seed, w))
        states.append(np.random.get_state())
    out = []
    try:
        for e in epochs:
            loader.set_epoch(e)
            for bid, idxs in enumerate(loader._index_batches()):
                w = bid % n
                np.random.set_state(states[w])
                out.append(collate([copies[w][i] for i in idxs]))
                states[w] = np.random.get_state()
    finally:
        np.random.set_state(saved)
    return out


def build_dataloader(dataset, batch_size, workers_per_gpu=0, dist=False,
                     shuffle=True, seed=0, **kwargs):
    """Parity: datasets/loader/build_loader.py:23-57. ``dist`` (an epoch
    sharded across processes) waits for distributed training: ROADMAP
    queue 1, item 10."""
    if dist:
        raise NotImplementedError("build_dataloader(dist=True): distributed "
                                  "loading is not ported yet")
    sampler = GroupSampler(dataset, batch_size, seed=seed) if shuffle \
        else None
    return DataLoader(dataset, batch_size, sampler=sampler,
                      num_workers=workers_per_gpu, seed=seed)
