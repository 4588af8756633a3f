"""Data parallelism over torch.distributed (counterpart of
ultra_torchdrug_tpu/parallel/distributed.py): the process group, and the
collectives of the engine and the eval loop.

One process drives one data row, as DDP does: every rank holds the whole
model and the whole graph, trains on its rows of each global batch, and
mean-all-reduces its gradients; evaluation scores a round-robin shard of
the eval triples on every rank and gathers the rankings in their original
order.

Backend rule (``initialize_distributed`` logs the one it takes):
  * ``nccl`` when every rank has a card of its own: the device is "cuda"
    with no index and the host has at least as many cards as local ranks;
    rank r then runs on ``cuda:LOCAL_RANK``;
  * ``gloo`` when ranks share a card (fewer cards than local ranks, or a
    device with an index, which every rank then names) or run on the CPU;
    NCCL refuses two ranks on one card.
Under gloo, ``all_reduce`` and ``broadcast`` take CUDA tensors; gloo takes
none for ``all_gather``, so ``gather_rankings`` gathers on the host under
gloo. This is a fixed rule of the backend, not a fallback.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import LOGGER_NAME

_STATE = {"device": None}


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def backend_rule(device, local_rank: int, local_world_size: int,
                 cuda_count: Optional[int] = None):
    """(backend, this rank's device) for ranks on ``device`` (the module
    docstring's rule)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", torch.device("cpu")
    if device.index is not None:
        return "gloo", device
    if cuda_count is None:
        cuda_count = torch.cuda.device_count()
    if cuda_count < 1:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    if cuda_count >= local_world_size:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cuda_count)


def initialize_distributed(world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           init_method: Optional[str] = None,
                           device=None,
                           local_rank: Optional[int] = None,
                           local_world_size: Optional[int] = None) -> bool:
    """Join the process group. The arguments default to torchrun's
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT`` (``init_method`` "env://"); explicit
    values take their place, as a coordinator address does in the JAX
    package (e.g. ``init_method="tcp://localhost:29500"``). With one
    process it is a no-op and returns False. ``device`` is where the ranks
    run ("cuda" unless the caller names another); ``rank_device`` then
    gives this rank's."""
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else int(world_size)
    if world_size <= 1:
        return False
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", rank)
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", world_size)
    backend, rank_dev = backend_rule(
        "cuda" if device is None else device, local_rank, local_world_size)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} processes is "
                f"already initialized, not {world_size}")
        return True
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _STATE["device"] = rank_dev
    logging.getLogger(LOGGER_NAME).info(
        "process group: rank %d of %d, backend %s, device %s", rank,
        world_size, backend, rank_dev)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def rank_device(device=None) -> torch.device:
    """This rank's device under a process group (``backend_rule``), else
    ``device`` as the caller named it."""
    if is_distributed() and _STATE["device"] is not None:
        return _STATE["device"]
    return torch.device("cuda" if device is None else device)


def all_reduce_mean(flat: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of ``flat`` (the gradients of an update in
    one buffer), in place: one collective."""
    if is_distributed():
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())
    return flat


def any_rank(flag: bool, device=None) -> bool:
    """True on every rank when ``flag`` is True on any (one all-reduce)."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=rank_device(device))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The elementwise mean of ``t`` over the ranks."""
    if not is_distributed():
        return t
    buf = t.clone()
    dist.all_reduce(buf)
    return buf.div_(dist.get_world_size())


def reduce_metrics_mean(metrics: Dict[str, float]) -> Dict[str, float]:
    """A metric dict's mean over the ranks (the reference's
    comm.reduce(op="mean"))."""
    if not is_distributed():
        return metrics
    keys = sorted(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                       device=rank_device())
    return dict(zip(keys, mean_over_ranks(vec).tolist()))


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Copy rank ``src``'s values into ``tensors`` on every rank (one flat
    buffer, one broadcast)."""
    tensors = list(tensors)
    if not is_distributed() or not tensors:
        return
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src)
        lo = 0
        for t in tensors:
            t.copy_(flat[lo:lo + t.numel()].view_as(t))
            lo += t.numel()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (a picklable value) on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def gather_rankings(ranking: np.ndarray,
                    total: Optional[int] = None) -> np.ndarray:
    """Every rank's eval results, in the original triple order (the
    reference's comm.cat): the process-major concatenation of the
    round-robin shards is inverted so that row i is triple i again;
    ``total`` drops the padding ``shard_eval_triples`` added."""
    if not is_distributed():
        return ranking
    P = dist.get_world_size()
    device = (torch.device("cpu") if dist.get_backend() == "gloo"
              else rank_device())
    local = torch.from_numpy(np.ascontiguousarray(ranking)).to(device)
    parts = [torch.empty_like(local) for _ in range(P)]
    dist.all_gather(parts, local)
    flat = torch.cat(parts).cpu().numpy()
    out = invert_round_robin(flat, P)
    return out[:total] if total is not None else out


def invert_round_robin(flat: np.ndarray, P: int) -> np.ndarray:
    """Reorder a process-major concatenation of round-robin shards back to
    the original order: flat row p * n_shard + j held index j * P + p."""
    n_pad = len(flat)
    order = np.concatenate([np.arange(p, n_pad, P) for p in range(P)])
    out = np.empty_like(flat)
    out[order] = flat
    return out


def shard_eval_triples(triples: np.ndarray,
                       num_processes: Optional[int] = None,
                       index: Optional[int] = None) -> np.ndarray:
    """This rank's round-robin shard of the eval triples (the reference's
    DistributedSampler), padded with copies of row 0 to a multiple of the
    process count so that every shard has one shape; ``gather_rankings``
    drops the padding and restores the order."""
    P = process_count() if num_processes is None else int(num_processes)
    if P == 1:
        return triples
    p = process_index() if index is None else int(index)
    pad = (-len(triples)) % P
    if pad:
        triples = np.concatenate([triples, np.repeat(triples[:1], pad, 0)], 0)
    return triples[p::P]
