"""End result: the port's capture basin is not inverted, on the CPU.

The second assertion of tests/test_capture_range.py:86
(``test_capture_radius_profile``, marked slow there), on its rig and with
its thresholds (test_torch_capture_range.py's rig and convergence test):
along the se(3) direction drawn from numpy's default_rng(7), the
perturbations of norm 0.15 and 0.3 are calibrated and printed; beyond the
basin a radius may fail, but if 0.3 converges, 0.15 must.
"""
from test_torch_capture_range import profile_run, rig  # noqa: F401  (rig: the fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_capture_radius_profile_not_inverted(rig):
    ok_mid, errs_mid = profile_run(rig, 0.15)
    ok_far, errs_far = profile_run(rig, 0.3)
    if ok_far:
        assert ok_mid, (errs_mid, errs_far)
