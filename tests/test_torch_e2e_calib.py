"""End result: offline calibration on synthetic data recovers the ground
truth, through the port's trainer on the CPU.

Counterpart of tests/test_e2e_calib.py:113
(``TestSyntheticPipeline.test_offline_calibration_recovers_gt``, marked
slow there), on its rig and with its thresholds: its two-joint arm
(``ARM_URDF``, copied below) at 120×160, f = 140, rendered by the port's
``generate_dataset`` (5 frames, seed 2, the default camera at 1 m, 30°,
0.6 m) on the tiled renderer at ``TileConfig(16, 32, 64)``; then
``run_offline_calibration`` with a default ``Config`` (the dense fused
route) at 16×32 tiles, cap 64, 300 Adam steps at lr 3e-3, from the GT
perturbed by [0.03, -0.02, 0.03, 0.03, -0.02, 0.04] (~4 cm and ~3°). The
loss must fall below 15 % of its start, the pose end within 1 cm and 1° of
the GT (geodesic), the history hold 300 poses starting at the init, and
the run's artifacts be on disk. The port's ``generate_dataset`` draws
from a torch.Generator, so the test passes it the JAX test's joint angles
(``jax.random.uniform`` from PRNGKey(2) within half the joint limits, as
easyhec_tpu's generate_dataset draws them): the same dataset.
"""
import jax
import numpy as np
import pytest
import torch

from easyhec_torch.config import Config
from easyhec_torch.data import generate_dataset
from easyhec_torch.data.synthetic import default_camera
from easyhec_torch.geometry import se3
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
from easyhec_torch.trainer import run_offline_calibration
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ARM_URDF = """<?xml version="1.0"?>
<robot name="mini_arm">
  <link name="base">
    <visual><geometry><cylinder radius="0.06" length="0.1"/></geometry>
      <origin xyz="0 0 0.05" rpy="0 0 0"/></visual>
  </link>
  <link name="upper">
    <visual><geometry><box size="0.07 0.07 0.3"/></geometry>
      <origin xyz="0 0 0.15" rpy="0 0 0"/></visual>
  </link>
  <link name="fore">
    <visual><geometry><box size="0.05 0.05 0.25"/></geometry>
      <origin xyz="0 0 0.125" rpy="0 0 0"/></visual>
  </link>
  <joint name="shoulder" type="revolute">
    <origin xyz="0 0 0.1" rpy="0 0 0"/>
    <parent link="base"/><child link="upper"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="1.5" velocity="1" effort="10"/>
  </joint>
  <joint name="elbow" type="revolute">
    <origin xyz="0 0 0.3" rpy="0 0 0"/>
    <parent link="upper"/><child link="fore"/>
    <axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="2.0" velocity="1" effort="10"/>
  </joint>
</robot>
"""

H, W = 120, 160
K = np.array([[140.0, 0, 80], [0, 140.0, 60], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rig")
    urdf = tmp / "mini_arm.urdf"
    urdf.write_text(ARM_URDF)
    model = parse_urdf(urdf)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    renderer = RobotRenderer([meshes[n] for n in LINKS], H, W, tile=TileConfig(16, 32, 64),
                             mode="tiled", device="cpu")
    return urdf, chain, renderer, tmp


def test_offline_calibration_recovers_gt(rig):
    urdf, chain, renderer, tmp = rig
    Tc = default_camera(distance=1.0, azimuth_deg=30, height=0.6, target=(0, 0, 0.3))
    out = tmp / "synth2"
    lim = chain.joint_limits * 0.5
    qposes = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (5, chain.n_dof),
                                           minval=lim[:, 0], maxval=lim[:, 1]))
    generate_dataset(out, chain, renderer, LINKS, Tc, K, n_frames=5, seed=2, qposes=qposes)

    cfg = Config()
    cfg.model.urdf_path = str(urdf)
    cfg.model.use_links = LINKS
    cfg.model.H, cfg.model.W = H, W
    cfg.render.tile_h, cfg.render.tile_w, cfg.render.capacity = 16, 32, 64
    cfg.solver.num_epochs = 300
    cfg.solver.max_lr = 3e-3
    cfg.dataset.data_dir = str(out)
    cfg.output_dir = str(tmp / "run")

    # Perturbed init: ~4cm + ~3deg off
    gt_dof = se3.log(torch.from_numpy(Tc)).numpy()
    init = gt_dof + np.array([0.03, -0.02, 0.03, 0.03, -0.02, 0.04], np.float32)
    result = run_offline_calibration(cfg, init_dof=init, device="cpu")

    assert result.losses[-1] < 0.15 * result.losses[0]
    assert result.metrics, "GT present -> metrics must be emitted"
    assert result.metrics["err_trans_geodesic_cm"] < 1.0, result.metrics
    assert result.metrics["err_rot_geodesic_deg"] < 1.0, result.metrics
    # History = pose per step, first entry = init
    assert result.history.shape == (300, 6)
    np.testing.assert_allclose(result.history[0], init, atol=1e-6)
    # Artifacts on disk
    run_dir = tmp / "run"
    assert (run_dir / "Tc_c2b.txt").exists()
    assert (run_dir / "metrics.json").exists()
    assert (run_dir / "config.yaml").exists()
    assert (run_dir / "checkpoints" / "final.npz").exists()
    assert (run_dir / "metrics.jsonl").exists()
