"""Port parity: easyhec_torch.solver.optim.make_optimizer's options against
easyhec_tpu's (optax) on the CPU: grad_clip (clip_by_global_norm),
grad_clip_value (optax.clip), weight_decay (AdamW) and the bias/weight
parameter groups (bias_lr_factor, weight_decay_bias; optax.multi_transform),
each alone and all together, for adam and sgd, on one tensor and on a
params dict with nested ``bias`` keys.

Tolerances: the updates over 12 steps of warmup_cosine at
test_optimizer_under_schedule_matches_optax's, rtol 1e-6 with an absolute
floor of eps·lr. The state leaves in jax.tree_util.tree_leaves order:
dtype and shape equal, the int32 counts equal, the float leaves rtol 1e-6
with a floor of one ulp of the leaf's largest entry per step,
STEPS·eps·max|leaf|: each step's moment or trace recurrence may round once
differently (XLA fuses sgd's g + momentum·trace into one fma where torch
rounds the product first; the global norm sums in another order), and
cancellation can leave that difference on a small entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from easyhec_torch.solver.optim import make_optimizer as t_make_optimizer
from easyhec_tpu.solver.optim import make_optimizer as j_make_optimizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

LR, STEPS = 0.1, 12
EPS = np.finfo(np.float32).eps
SCHED = dict(max_lr=LR, total_steps=STEPS, scheduler="warmup_cosine", warmup_steps=3)
# a U-Net-like tree: "bias" on leaf keys, in a key's middle and on a subtree
SHAPES = {"Conv_0": {"kernel": (3, 3, 2, 4), "bias": (4,)},
          "head_bias": (5,),
          "blocks": [{"kernel": (6,), "scale": (2,)}, {"bias": {"a": (3,), "b": (2,)}}],
          "Dense_1": {"kernel": (4, 3)}}
OPTIONS = {
    "default": {},
    "grad_clip": dict(grad_clip=0.5),
    "grad_clip_value": dict(grad_clip_value=0.05),
    "weight_decay": dict(weight_decay=0.1),
    "bias_lr_factor": dict(bias_lr_factor=2.0),
    "weight_decay_bias": dict(weight_decay_bias=0.2),
    "all": dict(grad_clip=0.5, grad_clip_value=0.05, weight_decay=0.1,
                bias_lr_factor=2.0, weight_decay_bias=0.3),
}


def _tree(rng):
    return jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), SHAPES,
                                  is_leaf=lambda x: isinstance(x, tuple))


def _as(tree, f):
    return jax.tree_util.tree_map(f, tree)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        tree, is_leaf=torch.is_tensor)]


def _check_state(jstate, topt, tstate):
    lj, lt = jax.tree_util.tree_leaves(jstate), topt.leaves(tstate)
    assert len(lt) == len(lj)
    for a, b in zip(lj, lt):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.int32:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6,
                                       atol=STEPS * EPS * np.abs(a).max(initial=0))


@pytest.mark.parametrize("params", ["tensor", "tree"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_options_match_optax(name, option, params):
    rng = np.random.default_rng(7)
    jopt = j_make_optimizer(name, **SCHED, **OPTIONS[option])
    topt = t_make_optimizer(name, **SCHED, **OPTIONS[option])
    p = _tree(rng) if params == "tree" else rng.normal(size=6).astype(np.float32)
    js, ts = jopt.init(_as(p, jnp.asarray)), topt.init(_as(p, torch.from_numpy))
    for _ in range(STEPS):
        g = _as(p, lambda a: rng.normal(size=a.shape).astype(np.float32))
        uj, js = jopt.update(_as(g, jnp.asarray), js, _as(p, jnp.asarray))
        ut, ts = topt.update(_as(g, torch.from_numpy), ts, _as(p, torch.from_numpy))
        if params == "tree":
            assert isinstance(ut, dict) and list(ut) == list(p)
        for a, b in zip(_leaves_np(uj), _leaves_np(ut)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=EPS * LR)
        p = jax.tree_util.tree_map(lambda a, u: (a + np.asarray(u)).astype(np.float32), p, uj)
    _check_state(js, topt, ts)


def test_state_leaves_resume():
    """leaves() -> from_leaves() resumes a grouped AdamW over a tree exactly,
    and a grouped state puts the bias group's leaves first (sorted keys)."""
    rng = np.random.default_rng(3)
    opt = t_make_optimizer("adam", **SCHED, **OPTIONS["all"])
    p = _as(_tree(rng), torch.from_numpy)
    s = opt.init(p)
    # the bias leaves in sorted-key order: Conv_0/bias, blocks[1]/bias/a and
    # /b, head_bias; then the weight group: Conv_0/kernel, Dense_1/kernel,
    # blocks[0]/kernel and /scale
    bias, weight = [(4,), (3,), (2,), (5,)], [(3, 3, 2, 4), (4, 3), (6,), (2,)]
    assert [tuple(x.shape) for x in opt.leaves(s)] == (
        [()] + bias + bias + [(), ()] + weight + weight + [()])
    g = _as(_tree(rng), torch.from_numpy)
    u1, s1 = opt.update(g, opt.from_leaves([x.clone() for x in opt.leaves(s)]), p)
    u2, s2 = opt.update(g, s, p)
    for a, b in zip(_leaves_np(u1) + opt.leaves(s1), _leaves_np(u2) + opt.leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bias_lr_groups():
    """JAX's test_bias_lr_groups (tests/test_solver.py) on the port, beside
    JAX's own ratio."""
    ratios = []
    for make, arr in ((t_make_optimizer, torch.ones), (j_make_optimizer, jnp.ones)):
        params = {"w": arr(3), "bias": arr(3)}
        opt = make("sgd", 1.0, 10, "constant", bias_lr_factor=2.0, momentum=0.0)
        upd, _ = opt.update({"w": arr(3), "bias": arr(3)}, opt.init(params), params)
        ratios.append(float(upd["bias"][0] / upd["w"][0]))
    assert ratios[0] == pytest.approx(2.0) and ratios[0] == ratios[1]


def test_weight_decay_needs_params():
    for make, arr in ((t_make_optimizer, torch.ones), (j_make_optimizer, jnp.ones)):
        opt = make("adam", weight_decay=0.1)
        with pytest.raises(ValueError):
            opt.update(arr(3), opt.init(arr(3)))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name,kw,n_ops", [
    ("adam", {}, 24), ("adam", dict(grad_clip=1.0), 31), ("sgd", {}, 6),
])
def test_default_tensor_path_ops(name, kw, n_ops):
    """The calibration's path (a bare tensor, no new option) runs the aten
    ops it ran before the options were added: no tree walk, no extra op.
    Adam's bias corrections raise a scalar base to the count (pow.Scalar),
    with no scalar tensor made on the device (two lift_fresh fewer than
    before), so the update can be captured in a CUDA graph."""
    opt = t_make_optimizer(name, max_lr=3e-3, **kw)
    p = torch.linspace(-1, 1, 6)
    s, g = opt.init(p), p * 0.5
    with _Ops() as rec:
        opt.update(g, s, p)
    assert len(rec.ops) == n_ops, rec.ops
    assert not any("cat" in o or "stack" in o for o in rec.ops)
    assert "aten.lift_fresh.default" not in rec.ops  # no tensor from a host scalar
