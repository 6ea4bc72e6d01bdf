"""Host-side communication between processes.

Counterpart of easyhec_tpu/parallel/comm.py (which wraps
jax.experimental.multihost_utils) on ``torch.distributed``, as the
reference's detectron2-derived comm layer (easyhec/utils/comm.py:25-279)
was: rank and world size, a barrier, gathers of host arrays and of
picklable objects, and a reduced metric dict. Host arrays travel on a gloo
group: the default group when its backend is gloo, else a gloo side group
made beside the NCCL default group at first use (every rank calls these
functions together, as it calls any collective). Each function is a no-op
or the identity when no process group is initialized.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "process_count",
    "process_index",
    "is_main_process",
    "sync",
    "all_gather_arrays",
    "all_gather_objects",
    "reduce_dict",
]

# The gloo side group of each default group it was made for (by object id).
_side_groups: dict[int, object] = {}


def _host_group():
    """The group host tensors travel on (None: the default group)."""
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.group.WORLD)
    if key not in _side_groups:
        _side_groups[key] = dist.new_group(backend="gloo")
    return _side_groups[key]


def _single() -> bool:
    return not dist.is_initialized() or dist.get_world_size() == 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def sync() -> None:
    """Cross-process barrier (reference comm.synchronize, comm.py:70-83)."""
    if _single():
        return
    dist.barrier(group=_host_group())


def all_gather_arrays(x: np.ndarray) -> np.ndarray:
    """Gather a same-shaped array from every process -> [P, ...]."""
    x = np.asarray(x)
    if _single():
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_host_group())
    return torch.stack(out).numpy()


def all_gather_objects(obj) -> list:
    """Gather arbitrary picklable objects from every process.

    The reference's pickle->tensor->pad->all_gather transport
    (comm.py:98-180): the byte sizes first, then one padded byte gather."""
    if _single():
        return [obj]
    payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
    sizes = all_gather_arrays(np.asarray([payload.size], np.int64))[:, 0]
    buf = np.zeros(int(sizes.max()), np.uint8)
    buf[: payload.size] = payload
    gathered = all_gather_arrays(buf)
    return [pickle.loads(gathered[p, : int(sizes[p])].tobytes())
            for p in range(gathered.shape[0])]


def reduce_dict(metrics: dict[str, float], average: bool = True) -> dict[str, float]:
    """Average (or sum) a {name: scalar} dict across processes, in f64
    (reference comm.reduce_dict, comm.py:240-269)."""
    if _single():
        return dict(metrics)
    keys = sorted(metrics)
    vec = np.asarray([float(metrics[k]) for k in keys], np.float64)
    allv = all_gather_arrays(vec)
    red = allv.mean(axis=0) if average else allv.sum(axis=0)
    return {k: float(v) for k, v in zip(keys, red)}
