"""Port parity: easyhec_torch.solver.optim's LR schedules and optimizer
against easyhec_tpu's (optax) on the CPU.

Tolerances: each schedule's lr at every step of 200, for both warmup
methods and warmup_steps in {0, 10}, rtol 1e-6 with an absolute floor of
one f32 ulp of max_lr (eps·max_lr = 3.6e-10 at 3e-3). The floor is there
because XLA's and torch's f32 cos differ by one ulp at about 2 % of
arguments. The cosine schedules' last steps compute 1 + cos(πt/T) with cos
near -1, where that ulp is up to 5e-5 of the lr (measured: 2.3e-10
absolute at most). A 30-step adaptive ``calibrate`` under warmup_cosine is
held at test_torch_calib.py's trace tolerance (losses rtol 1e-3, pose
atol 1e-4), on test_torch_brute.py's rig (the brute route: the schedule
is the subject, and that route is the cheapest to run in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyhec_torch.models import calib as tc
from easyhec_torch.solver.optim import make_optimizer as t_make_optimizer
from easyhec_torch.solver.optim import make_schedule as t_make_schedule
from easyhec_tpu.models import calib as jc
from easyhec_tpu.solver.optim import make_optimizer as j_make_optimizer
from easyhec_tpu.solver.optim import make_schedule as j_make_schedule

from test_torch_brute import CFG, K, OFFSET, _pair, calib_rig, scene  # noqa: F401  (fixtures)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

NAMES = ["constant", "cosine", "cosine_annealing", "warmup_cosine", "multistep",
         "warmup_multistep", "exponential", "warmup_exponential", "exponential_step",
         "onecycle"]
MAX_LR, STEPS = 3e-3, 200
KW = dict(milestones=(120, 50), gamma=0.5, decay_steps=80, min_factor=0.05)


def _lrs_jax(name, **kw):
    sched = j_make_schedule(name, MAX_LR, STEPS, **kw)
    lr = jax.vmap(lambda c: jnp.asarray(sched(c), jnp.float32))(jnp.arange(STEPS, dtype=jnp.int32))
    return np.asarray(lr)


def _lrs_torch(name, **kw):
    lr = t_make_schedule(name, MAX_LR, STEPS, **kw)(torch.arange(STEPS, dtype=torch.int32))
    return np.broadcast_to(np.asarray(lr.numpy() if torch.is_tensor(lr) else lr, np.float32),
                           (STEPS,))


@pytest.mark.parametrize("name", NAMES)
def test_schedule_matches_optax(name):
    for method in ("linear", "constant"):
        for warmup in (0, 10):
            kw = dict(KW, warmup_steps=warmup, warmup_method=method)
            lj, lt = _lrs_jax(name, **kw), _lrs_torch(name, **kw)
            assert np.isfinite(lj).all() and lj.max() > 0
            np.testing.assert_allclose(lt, lj, rtol=1e-6,
                                       atol=np.finfo(np.float32).eps * MAX_LR,
                                       err_msg=f"{name} {method} {warmup}")


def test_unknown_names_raise_in_both():
    for make in (t_make_schedule, j_make_schedule):
        with pytest.raises(ValueError, match="unknown scheduler"):
            make("linear_cycle", MAX_LR, STEPS)
    with pytest.raises(ValueError, match="warmup_method"):
        t_make_schedule("cosine", MAX_LR, STEPS, warmup_steps=5, warmup_method="step")


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_multistep", "onecycle"])
def test_optimizer_under_schedule_matches_optax(name):
    """Adam's updates and its schedule count leaf (opt_3) over 12 steps."""
    rng = np.random.default_rng(5)
    kw = dict(warmup_steps=4, milestones=(6,), gamma=0.3)
    jopt = j_make_optimizer("adam", max_lr=MAX_LR, total_steps=12, scheduler=name, **kw)
    topt = t_make_optimizer("adam", max_lr=MAX_LR, total_steps=12, scheduler=name, **kw)
    p = rng.normal(size=6).astype(np.float32)
    js, ts = jopt.init(jnp.asarray(p)), topt.init(torch.from_numpy(p))
    for _ in range(12):
        g = rng.normal(size=6).astype(np.float32)
        uj, js = jopt.update(jnp.asarray(g), js, jnp.asarray(p))
        ut, ts = topt.update(torch.from_numpy(g), ts, torch.from_numpy(p))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-6,
                                   atol=np.finfo(np.float32).eps * MAX_LR)
    for a, b in zip(jax.tree_util.tree_leaves(js), topt.leaves(ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_calibrate_warmup_cosine_matches_jax(calib_rig):  # noqa: F811
    coarse, lp, gt, target = calib_rig
    jr, tr = _pair(coarse, mode="brute", **CFG)
    init = gt + OFFSET
    kw = dict(num_steps=30, rebin_every=0, scheduler="warmup_cosine")
    jres = jc.calibrate(init, jr, lp, K, target, **kw)
    tres = tc.calibrate(init, tr, lp, K, target, **kw)
    assert tres.rebins == jres.rebins and not tres.overflow
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.history, jres.history, atol=1e-4)
    np.testing.assert_allclose(tres.dof, jres.dof, atol=1e-4)
    assert tres.losses[-1] < tres.losses[0]
