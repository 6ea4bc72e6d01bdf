"""Learning-rate range test ("LR finder").

Counterpart of easyhec_tpu/solver/lr_finder.py (the reference trainer's
find_lr: an exponential LR sweep, the loss EMA-smoothed, a stop on
divergence, the steepest-descent LR suggested), with autograd for the
gradient, so it also sweeps the 6-dof calibration loss through the fused
kernels on the card: one forward and one backward launch per step. The
JAX package runs the sweep as one jitted ``lax.scan``; here, on CUDA
parameters, one step (the loss, its gradient, the update at the lr of a
device step index, the loss written to a device buffer) is captured as a
CUDA graph and replayed ``num_steps`` times, and the host reads the losses
once. A loss that cannot be captured (one that reads the device from the
host) raises, as JAX's jit fails on it. On the CPU the step runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import cuda_graph
from .optim import make_optimizer

__all__ = ["LRFindResult", "find_lr"]


@dataclass
class LRFindResult:
    lrs: np.ndarray  # [N] swept learning rates
    losses: np.ndarray  # [N] raw losses
    smoothed: np.ndarray  # [N] EMA-smoothed losses
    suggestion: float  # LR at the steepest smoothed descent
    diverged_at: int  # first index where loss > divergence_th * best (or N)


def _leaves(params):
    if torch.is_tensor(params):
        return [params], lambda ls: ls[0]
    if isinstance(params, dict):
        keys = list(params)
        return [params[k] for k in keys], lambda ls: dict(zip(keys, ls))
    return list(params), lambda ls: type(params)(ls)


def find_lr(
    loss_fn,
    params,
    start_lr: float = 1e-6,
    end_lr: float = 1.0,
    num_steps: int = 100,
    beta: float = 0.9,
    divergence_th: float = 4.0,
    optimizer: str = "adam",
) -> LRFindResult:
    """Exponential LR range test on ``loss_fn(params) -> scalar tensor``;
    ``params`` a tensor, or a list, tuple or dict of tensors (on the device
    the loss runs on).

    Runs SGD (the raw gradient) or Adam (optax's scale_by_adam: the moments
    and bias correction, no lr) steps ``p - lr·u`` with lr growing
    geometrically from start_lr to end_lr, recording the loss BEFORE each
    step. The suggestion is the lr at the minimum d(smoothed loss)/d(log
    lr), restricted to the pre-divergence prefix.
    """
    gamma = (end_lr / start_lr) ** (1.0 / max(num_steps - 1, 1))
    lrs = start_lr * gamma ** torch.arange(num_steps, dtype=torch.float32)
    if optimizer == "adam":
        # lr 1 makes make_optimizer's update −u: p + lr·(−u) is p − lr·u
        adam = make_optimizer("adam", max_lr=1.0)
    elif optimizer != "sgd":
        raise ValueError(f"unknown optimizer {optimizer!r}")

    leaves, rebuild = _leaves(params)
    dev = leaves[0].device
    p = [t.detach().clone() for t in leaves]
    states = [adam.init(t) for t in p] if optimizer == "adam" else []
    n_state = len(adam.leaves(states[0])) if states else 0
    bufs = dict(
        p=p,
        state=[leaf.clone() for s in states for leaf in adam.leaves(s)],
        lrs=lrs.to(dev),
        idx=torch.zeros(1, dtype=torch.int64, device=dev),
        losses=torch.zeros(num_steps, dtype=torch.float32, device=dev),
    )

    def step(b):
        ps = [t.detach().requires_grad_() for t in b["p"]]
        loss = loss_fn(rebuild(ps))
        grads = torch.autograd.grad(loss, ps)
        b["losses"].index_copy_(0, b["idx"], loss.detach().reshape(1).float())
        lr = b["lrs"].index_select(0, b["idx"]).reshape(())
        with torch.no_grad():
            if not n_state:
                new = [t - lr * g for t, g in zip(b["p"], grads)]
            else:
                new = []
                for i, (t, g) in enumerate(zip(b["p"], grads)):
                    sl = b["state"][i * n_state:(i + 1) * n_state]
                    u, s = adam.update(g, adam.from_leaves(sl))
                    new.append(t + lr * u)
                    for buf, leaf in zip(sl, adam.leaves(s)):
                        buf.copy_(leaf)
            for buf, t in zip(b["p"], new):
                buf.copy_(t)
            b["idx"] += 1

    cuda_graph.repeat(step, bufs, num_steps, cuda_graph.captures(dev))
    losses = bufs["losses"].cpu().numpy()
    lrs_np = lrs.numpy()

    # EMA smoothing with bias correction (reference base.py:311-315)
    sm = np.empty_like(losses)
    avg = 0.0
    for i, x in enumerate(losses):
        avg = beta * avg + (1 - beta) * float(x)
        sm[i] = avg / (1 - beta ** (i + 1))

    best = np.minimum.accumulate(sm)
    div = np.nonzero((sm > divergence_th * best) | ~np.isfinite(sm))[0]
    end = int(div[0]) if len(div) else num_steps

    if end > 2:
        d = np.gradient(sm[:end], np.log(lrs_np[:end]))
        suggestion = float(lrs_np[:end][int(np.argmin(d))])
    else:
        suggestion = float(start_lr)
    return LRFindResult(
        lrs=lrs_np, losses=losses, smoothed=sm,
        suggestion=suggestion, diverged_at=end,
    )
