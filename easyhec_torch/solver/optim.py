"""Optimizer factory: optax's Adam / SGD chains, written out in torch.

Torch counterpart of easyhec_tpu/solver/optim.py::make_optimizer for the
configurations calibration runs: ``adam`` or ``sgd`` (momentum 0.9) under
the ``constant`` schedule, optionally after ``clip_by_global_norm``. The
arithmetic follows optax step for step (moments as ``(1-b)·g^k + b·m``,
bias correction by the incremented count, ``eps`` outside the square root,
the schedule's own step count), and the state keeps optax's leaves in
optax's order, so a run resumes across the two packages:

    adam: (count, mu, nu, schedule count)   = opt_0..opt_3
    sgd:  (trace, schedule count)           = opt_0..opt_1

The optimizer is functional: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller applies
``params + updates``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["make_optimizer", "Optimizer"]

_INT32_MAX = 2**31 - 1


class Optimizer(NamedTuple):
    init: object
    update: object
    leaves: object  # state -> list of tensors in optax leaf order
    from_leaves: object  # list of tensors -> state


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax.safe_increment for an int32 counter."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _schedule(name: str, max_lr: float):
    if name.lower() != "constant":
        raise NotImplementedError(
            f"scheduler {name!r} is not ported to easyhec_torch yet (ROADMAP.md); "
            "only 'constant' is"
        )
    return lambda count: max_lr


def _clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    g_norm = torch.sqrt(torch.sum(g * g))
    return torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)


def make_optimizer(
    name: str = "adam",
    max_lr: float = 3e-3,
    total_steps: int = 1000,
    scheduler: str = "constant",
    grad_clip: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    momentum: float = 0.9,
) -> Optimizer:
    """Build the gradient transformation for one parameter tensor."""
    sched = _schedule(scheduler, max_lr)
    lname = name.lower()

    def scale(u, sched_count):
        step = torch.tensor(-sched(sched_count), dtype=u.dtype, device=u.device)
        return step * u

    def clip(g):
        return _clip_by_global_norm(g, grad_clip) if grad_clip > 0 else g

    if lname == "adam":
        class State(NamedTuple):
            count: torch.Tensor
            mu: torch.Tensor
            nu: torch.Tensor
            sched_count: torch.Tensor

        def init(params):
            z = torch.zeros((), dtype=torch.int32, device=params.device)
            return State(z, torch.zeros_like(params), torch.zeros_like(params), z.clone())

        def update(g, state, params=None):
            g = clip(g)
            mu = (1 - b1) * g + b1 * state.mu
            nu = (1 - b2) * (g * g) + b2 * state.nu
            count = _inc(state.count)
            cf = count.to(g.dtype)
            mu_hat = mu / (1 - torch.pow(torch.tensor(b1, dtype=g.dtype, device=g.device), cf))
            nu_hat = nu / (1 - torch.pow(torch.tensor(b2, dtype=g.dtype, device=g.device), cf))
            u = mu_hat / (torch.sqrt(nu_hat) + eps)
            u = scale(u, state.sched_count)
            return u, State(count, mu, nu, _inc(state.sched_count))

    elif lname == "sgd":
        class State(NamedTuple):
            trace: torch.Tensor
            sched_count: torch.Tensor

        def init(params):
            return State(torch.zeros_like(params),
                         torch.zeros((), dtype=torch.int32, device=params.device))

        def update(g, state, params=None):
            trace = clip(g) + momentum * state.trace
            return scale(trace, state.sched_count), State(trace, _inc(state.sched_count))

    else:
        raise ValueError(f"unknown optimizer {name!r}")

    return Optimizer(
        init=init,
        update=update,
        leaves=lambda state: list(state),
        from_leaves=lambda leaves: State(*leaves),
    )
