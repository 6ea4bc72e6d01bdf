"""Multi-process initialization over ``torch.distributed``.

Counterpart of easyhec_tpu/parallel/distributed.py, with its environment
rendezvous:

    EASYHEC_COORDINATOR=host:port EASYHEC_NUM_PROCESSES=2 \\
    EASYHEC_PROCESS_ID=0 python -m easyhec_torch.cli.run -c cfg.yaml

Where the JAX package calls ``jax.distributed.initialize``, this calls
``torch.distributed.init_process_group``: NCCL when the process runs on
CUDA, gloo on the CPU (``EASYHEC_CPU_COLLECTIVES=gloo``, or no GPU). A
coordinator ``host:port`` becomes ``tcp://host:port``; an address with a
scheme (``file:///path``) is passed on as it is. With no coordinator, torch
reads torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
(``env://``), as JAX auto-detects a TPU pod. A failed init raises: no
backend stands in for another.

NCCL takes one rank per GPU. Several ranks on one card run gloo, chosen
explicitly (``backend="gloo"``); gloo reduces and broadcasts CUDA tensors
but gathers only host tensors (parallel.comm moves host arrays).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "maybe_init_from_env"]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    cpu_collectives: str | None = None,
    backend: str | None = None,
) -> None:
    """Initialize the default process group (idempotent).

    backend: None picks ``cpu_collectives`` when it is set, else NCCL when
    CUDA is available, else gloo. local_device_ids: the CUDA device of this
    process (its first entry); None on NCCL takes ``rank % device_count``
    (``LOCAL_RANK`` under env://)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = cpu_collectives or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if local_device_ids is not None:
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        torch.cuda.set_device(int(ids[0]))
    elif backend == "nccl":
        rank = process_id if process_id is not None else os.environ.get("LOCAL_RANK", 0)
        torch.cuda.set_device(int(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def maybe_init_from_env(backend: str | None = None) -> bool:
    """Initialize from EASYHEC_* env vars if present (the reference's
    WORLD_SIZE/LOCAL_RANK pattern, run_easyhec.py:41-50). Returns True if
    distributed mode was initialized."""
    coord = os.environ.get("EASYHEC_COORDINATOR")
    nproc = os.environ.get("EASYHEC_NUM_PROCESSES")
    if not coord and not nproc:
        return False
    init_distributed(
        coordinator_address=coord,
        num_processes=int(nproc) if nproc else None,
        process_id=int(os.environ["EASYHEC_PROCESS_ID"])
        if "EASYHEC_PROCESS_ID" in os.environ
        else None,
        cpu_collectives=os.environ.get("EASYHEC_CPU_COLLECTIVES"),
        backend=backend,
    )
    return True
