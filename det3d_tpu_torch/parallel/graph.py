"""A step as CUDA graphs: ``CapturedStep``, one graph per batch signature,
the counterpart of the JAX package's ``jax.jit(step_fn)``.

``make_predict_step`` (parallel/predict.py) and ``make_train_step`` /
``make_loss_eval_step`` (parallel/train.py) return one on a CUDA model
(``stepper``).
Every shape of those steps is fixed by the batch's shapes, and no
operation of them reads a device value on the host, so one captured
graph replays the whole step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from det3d_tpu_torch.parallel.dist_utils import backend
from det3d_tpu_torch.utils import trace


class _Graph:
    """One batch signature's graph: its static device inputs, the pinned
    host buffers they are copied from, its static outputs, and an event
    after the last copy out of the pinned buffers."""

    def __init__(self, tensors, device):
        self.static = {k: torch.empty(t.shape, dtype=t.dtype, device=device)
                       for k, t in tensors.items()}
        self.pinned = {k: torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
                       for k, t in tensors.items()}
        self.copied = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        self.out: Dict[str, torch.Tensor] = {}

    def stage(self, tensors):
        """Copy the batch into the static inputs on the current stream:
        host arrays through the pinned buffers, non-blocking; device
        tensors directly."""
        with trace.span("step.stage_wait"):
            self.copied.synchronize()   # the pinned buffers are free again
        with trace.span("step.stage_copy"):
            for k, t in tensors.items():
                if t.is_cuda:
                    self.static[k].copy_(t)
                else:
                    self.pinned[k].copy_(t)
                    self.static[k].copy_(self.pinned[k], non_blocking=True)
            self.copied.record()


class CapturedStep:
    """A step ``run(tensors on the card) -> {name: tensor}`` as CUDA graphs,
    one per batch signature (sorted keys, shapes and dtypes), as
    ``jax.jit`` traces one program per signature.

    ``step(batch)`` takes numpy arrays or tensors. It copies them into the
    signature's static device inputs (``_Graph.stage``: outside the graph,
    on the current stream), replays the graph on the current stream and
    returns clones of its outputs, which no later call overwrites. A new
    signature is first warmed up, then captured; a capture that fails
    raises.

    ``eager(batch)`` runs the same step eagerly, each operation launched
    from Python. ``warm_up(batch)`` runs it eagerly once on the capture
    stream, so that what the step sets up at its first call (the kernels'
    libraries and attributes, cuDNN's and cuBLAS's handles and workspaces,
    the anchors' device copy) is set up outside any capture.
    ``capture(batch)`` captures the batch's signature (after a warm-up) and
    returns its ``_Graph``; ``graphs`` maps signatures to them. The
    kernels' Python launch counters move while a graph is captured, once
    per launch, and not when it replays.

    ``state``: for a step that updates tensors in place (the train step:
    parameters, BatchNorm statistics, the optimizer's moments and count),
    a callable giving them; the warm-up leaves them as they were (copies
    taken before it are copied back after it), so that every call of the
    step advances them once.

    Its host spans (utils/trace.py, recorded while tracing is on):
    ``step.stage_wait``, the wait for the previous call's copies out of the
    pinned buffers; ``step.stage_copy``, the copies into the pinned and
    static buffers and the H2D enqueue; ``step.launch``, the graph's
    replay; ``step.outputs``, the outputs' clones; and, at a new
    signature, ``step.warm_up`` and ``step.capture``. A graph captured
    while tracing is on also carries the step's segment markers."""

    def __init__(self, run: Callable, device: torch.device,
                 state: Optional[Callable[[], List[torch.Tensor]]] = None):
        self._run = run
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graphs: Dict[tuple, _Graph] = {}
        self._state = state

    @staticmethod
    def tensors(batch) -> Dict[str, torch.Tensor]:
        """The batch as tensors, host arrays as CPU tensors sharing their
        memory."""
        return {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}

    @staticmethod
    def signature(tensors) -> tuple:
        return tuple(sorted((k, tuple(t.shape), t.dtype)
                            for k, t in tensors.items()))

    def eager(self, batch):
        return self._run({k: v.to(self.device) for k, v in
                          self.tensors(batch).items()})

    def warm_up(self, batch):
        state = self._state() if self._state is not None else []
        with trace.span("step.warm_up"):
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.stream):
                kept = [t.detach().clone() for t in state]
                self.eager(batch)
                with torch.no_grad():
                    for t, k in zip(state, kept):
                        t.copy_(k)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def capture(self, batch) -> _Graph:
        with trace.span("step.capture"):
            tensors = self.tensors(batch)
            entry = _Graph(tensors, self.device)
            entry.stage(tensors)
            with torch.cuda.graph(entry.graph, stream=self.stream):
                entry.out = self._run(entry.static)
            self.graphs[self.signature(tensors)] = entry
        return entry

    def __call__(self, batch):
        tensors = self.tensors(batch)
        entry = self.graphs.get(self.signature(tensors))
        if entry is None:
            self.warm_up(tensors)
            entry = self.capture(tensors)
        entry.stage(tensors)
        with trace.span("step.launch"):
            entry.graph.replay()
        with trace.span("step.outputs"):
            return {k: v.clone() for k, v in entry.out.items()}


def stepper(run: Callable, device: torch.device,
            state: Optional[Callable[[], List[torch.Tensor]]] = None,
            collective: bool = False):
    """``run`` as the step a user calls: on the card a CapturedStep, on the
    CPU (the caller asked for it) an eager function of host arrays or
    tensors, which is also its own ``.eager``.

    ``collective``: the step runs torch.distributed collectives (the train
    and loss-eval steps of ranks, parallel/train.py). The rule is the
    backend's: NCCL's collectives are captured in the step's CUDA graph
    like its kernels, so under NCCL the step is a CapturedStep, whose
    warm-up (eager, collectives included) every rank runs alike at its
    first call; gloo's collectives stage through the host and cannot be
    captured, so under gloo the step on the card is eager. This is decided
    from the backend before any capture, never from a capture that
    failed."""
    if device.type == "cuda" and not (collective and backend() == "gloo"):
        return CapturedStep(run, device, state)

    def step(batch):
        return run({k: torch.as_tensor(v, device=device)
                    for k, v in batch.items()})

    step.eager = step
    return step
