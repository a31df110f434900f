"""Ranks over torch.distributed: bring-up, rank info, barriers, reductions
of host values and the gather of picklable objects.

Port of det3d_tpu/parallel/dist_utils.py and of
det3d_tpu/parallel/mesh.py::initialize_distributed. Parity: reference
torchie/trainer/utils.py:22-183 and torchie/apis/env.py:13-52. The JAX
package runs one program over a mesh and its ``jax.process_*`` calls
count host processes; here each rank is a process with its own device,
and every function below runs over the default process group. Without
one (a single process) each is the identity, but ``all_reduce_sum``,
which its caller runs only while a group is up.

``reduce_dict`` and ``all_gather_objects`` move host values between ranks;
the differentiable sum of a tensor over ranks (``all_reduce_sum``) is the
collective of the synced BatchNorm (models/norm.py); the train step
all-reduces its gradients and metrics itself (parallel/train.py).
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional

import torch
import torch.distributed as dist


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the ``num_processes`` ranks as rank ``process_id``:
    ``init_process_group(init_method=f"tcp://{coordinator}")``, the
    coordinator a ``host:port`` that rank 0 listens on. Does nothing for
    one process (``num_processes`` None or 1). ``backend``: "nccl" for
    ranks on the card (the default, as every entry point runs on the card
    unless asked otherwise), "gloo" for ranks on the CPU or ranks that
    share one card, or the one the caller names; never chosen from what
    the machine has."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("initialize_distributed: num_processes="
                         f"{num_processes} needs a coordinator and a "
                         "process_id")
    dist.init_process_group(backend or "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def active() -> bool:
    """A default process group is up. The steps then run their collectives
    (with one rank too: phase 72 of chip_smoke.py holds that path)."""
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The default group's backend ("gloo", "nccl"), None without one."""
    return dist.get_backend() if active() else None


def get_dist_info():
    """(rank, world_size) of this process; (0, 1) without a group."""
    if active():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device) -> torch.device:
    """The device this rank computes on. Under NCCL a rank on the card
    takes the card ``rank % device_count`` (ranks of one host, numbered
    from 0, one card each) and makes it the current device; ranks under
    gloo, and a CPU device, keep ``device`` as given (ranks that share one
    card all use it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend() == "nccl":
        rank, _ = get_dist_info()
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def master_only(func):
    """Decorator: run only on rank 0 (torchie/trainer/utils.py:36-47);
    other ranks get None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)
        return None

    return wrapper


def synchronize() -> None:
    """Barrier over every rank (torchie/trainer/utils.py:99-111)."""
    if active() and dist.get_world_size() > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where a host value is staged for a collective: the current card
    under NCCL, the CPU otherwise."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(d: dict, average: bool = True) -> dict:
    """Mean (or sum) over ranks of a dict's scalar values, python floats
    or 0-d tensors (torchie/trainer/utils.py:157-183); returns python
    floats under the same keys on every rank."""
    if not active():
        return {k: float(v) for k, v in d.items()}
    keys = sorted(d)
    vec = torch.tensor([float(d[k]) for k in keys], dtype=torch.float64,
                       device=_comm_device())
    dist.all_reduce(vec)
    if average:
        vec /= dist.get_world_size()
    return dict(zip(keys, vec.cpu().tolist()))


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object from each rank, as a list in rank order, on
    every rank (torchie/trainer/utils.py:114-154)."""
    if not active():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over ranks; the gradient of x is the sum of y's
    gradients over ranks (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the default group's ranks, differentiable: one
    collective forward, one backward."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def broadcast_tensors(tensors, src: int = 0) -> None:
    """Copy rank ``src``'s values into every rank's ``tensors`` in place
    (one collective over a flat buffer a dtype)."""
    if not active():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))
