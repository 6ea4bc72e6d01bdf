"""End result: the port's capture range — from how far off an initial pose
does ``calibrate`` still converge? — on the CPU.

Counterpart of tests/test_capture_range.py:74 and :86
(``test_capture_radius_documented_floor`` and
``test_capture_radius_profile``, both marked slow there), on their rig and
with their thresholds: the two-joint arm of test_torch_e2e_calib.py
(``ARM_URDF``) at 96×128, f = 110, ``TileConfig(16, 32, 128,
binner="count", fused=True)`` (the dense fused route), four frames at q =
(0.3, -0.5), (-0.6, 0.9), (0.9, 0.4), (0, -1.2), the GT a look-at from
[0.9, 0.5, 0.7] to [0, 0, 0.25] and the target its thresholded silhouette;
each run 220 Adam steps at lr 6e-3, rebinning every 8, converged when it
ends within 1 cm (``err_trans``) and 1° (``err_rot``) of the GT.

Here the documented floor: two se(3) perturbations of norm 0.1, drawn
from numpy's default_rng(3), each converge (one case each). The profile
is split over test_torch_capture_profile.py (0.05 converges) and
test_torch_capture_basin.py (the basin is not inverted), so that three
workers share the seven calibrations (~75 s each on one CPU worker).
"""
import numpy as np
import pytest
import torch

from easyhec_torch.geometry import camera, se3
from easyhec_torch.models.calib import calibrate
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
from test_torch_e2e_calib import ARM_URDF
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

H, W = 96, 128
K = np.array([[110.0, 0, 64], [0, 110.0, 48], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    p = tmp_path_factory.mktemp("urdf") / "arm.urdf"
    p.write_text(ARM_URDF)
    model = parse_urdf(p)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    r = RobotRenderer([meshes[n] for n in LINKS], H, W, device="cpu",
                      tile=TileConfig(16, 32, 128, binner="count", fused=True))
    qs = torch.tensor([[0.3, -0.5], [-0.6, 0.9], [0.9, 0.4], [0.0, -1.2]])
    lp = chain.fk(qs)[:, [chain.link_index(n) for n in LINKS]]
    gt = se3.log(se3.inverse(camera.look_at(torch.tensor([0.9, 0.5, 0.7]),
                                            torch.tensor([0.0, 0.0, 0.25]),
                                            torch.tensor([0.0, 0.0, 1.0]))))
    with torch.no_grad():
        target = (r.silhouette(se3.exp(gt), lp, torch.from_numpy(K)) > 0.5).float()
    return r, lp, gt.numpy(), target


def _converges(rig_tuple, delta, steps=220):
    r, lp, gt, target = rig_tuple
    res = calibrate(gt + np.asarray(delta, np.float32), r, lp, K, target, num_steps=steps,
                    max_lr=6e-3, rebin_every=8,
                    Tc_c2b_gt=se3.exp(torch.from_numpy(gt)).numpy())
    err_t = res.metrics["err_trans"]  # cm
    err_r = res.metrics["err_rot"]  # deg
    return err_t < 1.0 and err_r < 1.0, (err_t, err_r)


@pytest.mark.parametrize("trial", [0, 1])
def test_capture_radius_documented_floor(rig, trial):
    # The documented floor: a coarse init within ~0.1 in se(3)-log norm
    # (≈6 cm translation + ≈4° rotation here) must converge.
    rng = np.random.default_rng(3)
    for _ in range(trial + 1):  # the trial-th draw of the sequence
        d = rng.normal(size=6)
    d = 0.1 * d / np.linalg.norm(d)
    ok, errs = _converges(rig, d)
    assert ok, (trial, d, errs)



def profile_run(rig_tuple, mag):
    """One point of test_capture_range.py:86's profile: the perturbation of
    norm ``mag`` along the unit se(3) direction drawn from numpy's
    default_rng(7), calibrated and printed -> (converged, (cm, deg))."""
    d = np.random.default_rng(7).normal(size=6)
    ok, errs = _converges(rig_tuple, mag * d / np.linalg.norm(d))
    print(f"capture-range profile: {mag}: {ok}, {errs[0]:.3f} cm, {errs[1]:.3f} deg")
    return ok, errs
