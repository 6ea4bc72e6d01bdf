"""Optimizer and LR schedule factories: optax's chains, written out in torch.

Torch counterpart of easyhec_tpu/solver/optim.py (``make_optimizer``,
``make_schedule``) for the configurations calibration runs: ``adam`` or
``sgd`` (momentum 0.9), optionally after ``clip_by_global_norm``, under any
of the JAX package's schedules:

    constant; cosine / cosine_annealing; warmup_cosine; multistep /
    warmup_multistep (absolute milestones, gamma); exponential;
    warmup_exponential; exponential_step; onecycle

with linear or constant warmup. The arithmetic follows optax step for step
(moments as ``(1-b)·g^k + b·m``, bias correction by the incremented count,
``eps`` outside the square root; each schedule's f32 formula in optax's
order of operations, evaluated on the device at the schedule's own step
count), and the state keeps optax's leaves in optax's order, so a run
resumes across the two packages:

    adam: (count, mu, nu, schedule count)   = opt_0..opt_3
    sgd:  (trace, schedule count)           = opt_0..opt_1

The optimizer is functional: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller applies
``params + updates``.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

__all__ = ["make_optimizer", "make_schedule", "Optimizer"]

_INT32_MAX = 2**31 - 1


class Optimizer(NamedTuple):
    init: object
    update: object
    leaves: object  # state -> list of tensors in optax leaf order
    from_leaves: object  # list of tensors -> state


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax.safe_increment for an int32 counter."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def _f32(count: torch.Tensor) -> torch.Tensor:
    return count.to(torch.float32)


def _linear(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule (polynomial of power 1, no transition_begin)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def sched(count):
        c = torch.clamp(count, 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    return sched


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")
    T = float(decay_steps)

    def sched(count):
        c = torch.clamp(_f32(count), max=T)
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / T))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return sched


def _join(first, second, boundary: int):
    """optax.join_schedules([first, second], [boundary])."""
    def sched(count):
        return torch.where(count < boundary, first(count), second(count - boundary))

    return sched


def _with_warmup(sched, max_lr, warmup_steps, warmup_factor, warmup_method):
    """Warmup ahead of ``sched``: 'linear' ramps the multiplier
    warmup_factor -> 1 over warmup_steps; 'constant' holds lr·warmup_factor
    until warmup_steps."""
    if warmup_steps <= 0:
        return sched
    if warmup_method == "linear":
        warm = _linear(max_lr * warmup_factor, max_lr, warmup_steps)
    elif warmup_method == "constant":
        warm = lambda count: max_lr * warmup_factor  # noqa: E731
    else:
        raise ValueError(f"unknown warmup_method {warmup_method!r}")
    return _join(warm, sched, warmup_steps)


def _onecycle(transition_steps: int, peak_value: float, pct_start: float = 0.3,
              div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule: piecewise cosine interpolation between
    the cumulative products of the boundary scales (f64 on the host, as
    optax's numpy tables)."""
    if transition_steps <= 0:
        raise ValueError("onecycle needs positive transition_steps")
    table = sorted({int(pct_start * transition_steps): div_factor,
                    int(transition_steps): 1.0 / (div_factor * final_div_factor)}.items())
    bounds = [0] + [b for b, _ in table]
    values = [peak_value / div_factor]
    for _, scale in table:
        values.append(values[-1] * scale)

    def sched(count):
        out = 0.0
        for lo, hi, start, end in zip(bounds[:-1], bounds[1:], values[:-1], values[1:]):
            pct = (count - lo) / (hi - lo)
            interp = end + (start - end) / 2.0 * (torch.cos(math.pi * pct) + 1)
            out = out + ((lo <= count) & (count < hi)).to(torch.float32) * interp
        return out + (bounds[-1] <= count).to(torch.float32) * values[-1]

    return sched


def make_schedule(
    name: str,
    max_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    gamma: float = 0.1,
    milestones: tuple[int, ...] = (),
    decay_steps: int = 250_000,
    min_factor: float = 0.1,
    warmup_factor: float = 1.0 / 3,
    warmup_method: str = "linear",
):
    """Step count (an int32 tensor) -> lr (an f32 tensor, or a float for
    ``constant``), as easyhec_tpu.solver.optim.make_schedule."""
    name = name.lower()
    if name == "constant":
        return lambda count: max_lr
    if name in ("cosine", "cosine_annealing", "warmup_cosine"):
        sched = _cosine_decay(max_lr, max(total_steps - warmup_steps, 1))
        steps = max(warmup_steps, 1) if name == "warmup_cosine" else warmup_steps
        return _with_warmup(sched, max_lr, steps, warmup_factor, warmup_method)
    if name in ("multistep", "warmup_multistep"):
        # Absolute milestones: lr = max_lr · gamma^#(milestones <= step) ·
        # the warmup multiplier (not shifted by the warmup length).
        ms = sorted(int(m) for m in milestones)

        def sched(count):
            step = _f32(count)
            if ms:
                mult = gamma ** sum((step >= m).to(torch.int32) for m in ms)
            else:
                mult = 1.0
            if warmup_steps > 0:
                if warmup_method == "linear":
                    a = torch.clamp(step / warmup_steps, 0.0, 1.0)
                    wmult = warmup_factor * (1 - a) + a
                elif warmup_method == "constant":
                    wmult = torch.where(step < warmup_steps,
                                        torch.full_like(step, warmup_factor),
                                        torch.ones_like(step))
                else:
                    raise ValueError(f"unknown warmup_method {warmup_method!r}")
            else:
                wmult = 1.0
            return max_lr * mult * wmult

        return sched
    if name in ("exponential", "warmup_exponential"):
        # continuous decay: lr · gamma^(step / decay_steps)
        def body(count):
            return max_lr * gamma ** (_f32(count) / decay_steps)

        if name == "exponential":
            return body
        return _with_warmup(body, max_lr, max(warmup_steps, 1), 0.0, "linear")
    if name == "exponential_step":
        # lr · exp(t · log(min_factor)), t = clip(step / total, 0, 1)
        # log in f32, as jnp.log of the python float
        log_f = float(torch.log(torch.tensor(min_factor, dtype=torch.float32)))

        def sched(count):
            t = torch.clamp(_f32(count) / total_steps, 0.0, 1.0)
            return max_lr * torch.exp(t * log_f)

        return sched
    if name == "onecycle":
        return _onecycle(total_steps, peak_value=max_lr)
    raise ValueError(f"unknown scheduler {name!r}")


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
    warmup_steps: int = 0,
    **sched_kwargs,
) -> Optimizer:
    """Build the gradient transformation for one parameter tensor.
    ``warmup_steps`` and ``sched_kwargs`` (gamma, milestones, decay_steps,
    min_factor, warmup_factor, warmup_method) go to make_schedule."""
    sched = make_schedule(scheduler, max_lr, total_steps, warmup_steps=warmup_steps,
                          **sched_kwargs)
    lname = name.lower()

    def scale(u, sched_count):  # no host-to-device copy: a float lr rides as a scalar
        lr = sched(sched_count)
        return (-lr.to(u.dtype) if torch.is_tensor(lr) else -lr) * u

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
