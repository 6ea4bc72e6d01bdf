"""Optimizer and LR schedule factories: optax's chains, written out in torch.

Torch counterpart of easyhec_tpu/solver/optim.py (``make_optimizer``,
``make_schedule``): ``adam`` (AdamW under ``weight_decay``) or ``sgd``
(momentum 0.9), after optional ``clip_by_global_norm`` and ``clip`` (by
value), over one tensor or a tree of tensors with optional bias/weight
parameter groups, under any of the JAX package's schedules:

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

for one tensor; over a tree, mu, nu and trace hold one leaf per tensor in
jax.tree_util's order (dict keys sorted), and with groups the state is the
"bias" group's leaves, then the "weight" group's (each group's mu, nu or
trace over its own tensors only). The clips and the weight decay add no
leaf. The state is that tuple of tensors.

The optimizer is functional: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; the caller applies
``params + updates``.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

__all__ = ["make_optimizer", "make_schedule", "Optimizer", "OptSpec"]

_INT32_MAX = 2**31 - 1


class OptSpec(NamedTuple):
    """The constants of a make_optimizer with one parameter group, which
    ops/step.py's update kernel applies to a bare tensor in ``update``'s
    order."""

    adam: bool
    b1: float
    b2: float
    eps: float
    momentum: float
    grad_clip: float
    grad_clip_value: float
    weight_decay: float  # adam's (sgd ignores it)
    lr: float | None  # the constant schedule's lr, else None
    sched: object  # the schedule: count -> lr


class Optimizer(NamedTuple):
    init: object
    update: object
    leaves: object  # state -> list of tensors in optax leaf order
    from_leaves: object  # list of tensors -> state
    spec: OptSpec | None = None  # one parameter group: the update's constants


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


def _flatten(tree):
    """Leaves of a tree of tensors (nested dict, list, tuple) in
    jax.tree_util.tree_leaves' order (dict keys sorted), each with its
    group: "bias" when a key on its path contains "bias" (JAX's _is_bias),
    else "weight"."""
    leaves, labels = [], []

    def walk(node, bias):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], bias or "bias" in str(k))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, x in zip(node._fields, node):
                walk(x, bias or "bias" in k)
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x, bias)
        elif node is not None:
            leaves.append(node)
            labels.append("bias" if bias else "weight")

    walk(tree, False)
    return leaves, labels


def _unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` (in _flatten's
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[build(x) for x in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return None if node is None else next(it)

    return build(like)


def _clip_by_global_norm(gs: list, max_norm: float) -> list:
    """optax.clip_by_global_norm: the norm over every leaf."""
    total = torch.sum(gs[0] * gs[0])
    for g in gs[1:]:
        total = total + torch.sum(g * g)
    g_norm = torch.sqrt(total)
    return [torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm) for g in gs]


def make_optimizer(
    name: str = "adam",
    max_lr: float = 3e-3,
    total_steps: int = 1000,
    scheduler: str = "constant",
    grad_clip: float = 0.0,
    grad_clip_value: float = 0.0,
    weight_decay: float = 0.0,
    warmup_steps: int = 0,
    momentum: float = 0.9,
    bias_lr_factor: float = 1.0,
    weight_decay_bias: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    **sched_kwargs,
) -> Optimizer:
    """Build the gradient transformation for a tensor or a tree of tensors
    (nested dict, list, tuple). ``warmup_steps`` and ``sched_kwargs``
    (gamma, milestones, decay_steps, min_factor, warmup_factor,
    warmup_method) go to make_schedule.

    In optax's order: clip by global norm (``grad_clip``), clip by value
    (``grad_clip_value``), then the core. ``weight_decay`` != 0 makes Adam
    AdamW (decay added after the Adam scaling, before −lr; sgd ignores it,
    as in the JAX package). When ``bias_lr_factor`` != 1 or
    ``weight_decay_bias`` != ``weight_decay`` the leaves split into a
    "bias" group (lr · bias_lr_factor, decay weight_decay_bias) and a
    "weight" group, each with its own core and state, as
    optax.multi_transform."""
    sched = make_schedule(scheduler, max_lr, total_steps, warmup_steps=warmup_steps,
                          **sched_kwargs)
    lname = name.lower()
    if lname not in ("adam", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    adam = lname == "adam"
    # (label, lr scale, weight decay) per group, in optax's leaf order:
    # multi_transform's groups flatten by sorted key, "bias" before "weight"
    if bias_lr_factor != 1.0 or weight_decay_bias != weight_decay:
        groups = (("bias", bias_lr_factor, weight_decay_bias),
                  ("weight", 1.0, weight_decay))
    else:
        groups = ((None, 1.0, weight_decay),)
    needs_params = adam and any(wd != 0 for _, _, wd in groups)

    def split(tree):
        if torch.is_tensor(tree):  # the calibration's dof: no tree walk
            return [tree], ("weight",)
        return _flatten(tree)

    def members(labels, label):
        return [i for i, lab in enumerate(labels) if label is None or lab == label]

    def scale(us, sched_count, lr_scale):  # a float lr rides as a scalar
        if not us:
            return []
        lr = sched(sched_count)
        if lr_scale != 1.0:
            lr = lr * lr_scale
        neg = -lr.to(us[0].dtype) if torch.is_tensor(lr) else -lr
        return [neg * u for u in us]

    def core_init(ps, device):
        z = torch.zeros((), dtype=torch.int32, device=device)
        if adam:
            return [z, *map(torch.zeros_like, ps), *map(torch.zeros_like, ps), z.clone()]
        return [*map(torch.zeros_like, ps), z]

    def core_update(gs, st, ps, lr_scale, wd):
        n = len(gs)
        if adam:  # optax.adam, or adamw when wd != 0
            mu = [(1 - b1) * g + b1 * m for g, m in zip(gs, st[1:1 + n])]
            nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(gs, st[1 + n:1 + 2 * n])]
            count = _inc(st[0])
            us = []
            if n:
                cf = count.to(gs[0].dtype)
                # b ** count with a scalar base: no host-to-device copy, so
                # the update can be captured in a CUDA graph
                c1 = 1 - torch.pow(b1, cf)
                c2 = 1 - torch.pow(b2, cf)
                us = [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]
                if wd != 0:
                    us = [u + wd * p for u, p in zip(us, ps)]
            return scale(us, st[-1], lr_scale), [count, *mu, *nu, _inc(st[-1])]
        trace = [g + momentum * t for g, t in zip(gs, st[:n])]
        return scale(trace, st[-1], lr_scale), [*trace, _inc(st[-1])]

    def init(params):
        ps, labels = split(params)
        device = ps[0].device
        state = []
        for label, _, _ in groups:
            state += core_init([ps[i] for i in members(labels, label)], device)
        return tuple(state)

    def update(grads, state, params=None):
        gs, labels = split(grads)
        if grad_clip > 0:
            gs = _clip_by_global_norm(gs, grad_clip)
        if grad_clip_value > 0:
            gs = [torch.clamp(g, -grad_clip_value, grad_clip_value) for g in gs]
        if needs_params:
            if params is None:
                raise ValueError("weight decay needs the params in update()")
            ps = split(params)[0]
        us, new_state, at = [None] * len(gs), [], 0
        for label, lr_scale, wd in groups:
            idx = members(labels, label)
            n = 2 + 2 * len(idx) if adam else 1 + len(idx)
            sub = [ps[i] for i in idx] if adam and wd != 0 else None
            gu, st = core_update([gs[i] for i in idx], state[at:at + n], sub, lr_scale, wd)
            for i, u in zip(idx, gu):
                us[i] = u
            new_state += st
            at += n
        out = us[0] if torch.is_tensor(grads) else _unflatten(grads, us)
        return out, tuple(new_state)

    spec = None
    if len(groups) == 1:
        spec = OptSpec(adam, b1, b2, eps, momentum, grad_clip, grad_clip_value, weight_decay,
                       max_lr if scheduler.lower() == "constant" else None, sched)
    return Optimizer(init=init, update=update, leaves=list, from_leaves=tuple, spec=spec)
