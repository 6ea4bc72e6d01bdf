"""End result: the port's capture-range profile at its smallest radius, on
the CPU.

The first assertion of tests/test_capture_range.py:86
(``test_capture_radius_profile``, marked slow there), on its rig and with
its thresholds (test_torch_capture_range.py's rig and convergence test):
along the se(3) direction drawn from numpy's default_rng(7), the
perturbation of norm 0.05 converges. Its second assertion, the basin not
inverted, is test_torch_capture_basin.py: the two share no calibration,
so they run on two workers.
"""
from test_torch_capture_range import profile_run, rig  # noqa: F401  (rig: the fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_capture_radius_profile(rig):
    ok, errs = profile_run(rig, 0.05)
    assert ok, errs
