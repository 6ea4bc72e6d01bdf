"""Port parity: easyhec_torch.parallel against easyhec_tpu.parallel on the
CPU, on tests/test_sharding.py's mini rig (W 64, bands of 32 rows, 2 bands).

The port runs in 4 gloo processes on a (2 data × 2 tile) mesh, started once
for the module from a script written to tmp_path (file:// rendezvous, one
torch thread each); each rank saves what it computed. JAX runs the same
functions in this process on make_mesh(2, 2) of its 8 virtual devices.
Tolerances are JAX's own (tests/test_sharding.py): silhouettes atol 1e-4,
the loss rtol 1e-4, the gradient against one-device mask_loss rtol 2e-3
and atol 1e-2, a calibrate trace's first 10 losses rtol 3e-3 and atol 1e-3
(band-split summation order, compounded by Adam) and its final pose atol
5e-3, frame_chunk against unchunked 1e-5 (the same sums, blockwise).
"""
import dataclasses
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from __graft_entry__ import MINI_URDF
from easyhec_torch import parallel as tpar
from easyhec_torch.geometry import se3 as tse3
from easyhec_torch.models import calib as tc
from easyhec_torch.parallel import comm as tcomm
from easyhec_torch.parallel import sharding as tsh
from easyhec_torch.render import RobotRenderer as TR
from easyhec_torch.render import TileConfig as TTC
from easyhec_torch.solver.optim import make_optimizer as t_make_optimizer
from easyhec_torch.utils import cuda_graph
from easyhec_tpu import parallel as jpar
from easyhec_tpu.config import load_config as j_load
from easyhec_tpu.data.synthetic import default_camera, generate_dataset
from easyhec_tpu.geometry import se3 as jse3
from easyhec_tpu.models import calib as jc
from easyhec_tpu.parallel import comm as jcomm
from easyhec_tpu.parallel import sharding as jsh
from easyhec_tpu.render import RobotRenderer as JR
from easyhec_tpu.render import TileConfig as JTC
from easyhec_tpu.robot import build_chain, load_link_meshes, parse_urdf
from easyhec_tpu.trainer import build_runtime as j_build_runtime
from easyhec_tpu.trainer import run_offline_calibration as j_run
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
W, BAND_H, N_TILE, N_DATA = 64, 32, 2, 2
H = BAND_H * N_TILE
K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], np.float32)
LINKS = ["base", "upper", "fore"]
# test_sharding.py's rig (the unfused route) and its production variants;
# caps cover the rig's true bin loads (max 98 at the start pose)
RIG = dict(tile_h=16, tile_w=32, capacity=128)
DENSE = dict(RIG, binner="count", fused=True, margin=2.0, bin_big_k=128, bwd_band_only=True)
COMPACT = dict(DENSE, bin_subsort_rows=True, compact_chunks=24, bwd_chunks=24)
OFFSET = np.array([0.01, -0.01, 0.01, 0.01, -0.005, 0.01], np.float32)
DENSE_KW = dict(num_steps=60, max_lr=3e-3, robust_delta=0.2, grad_clip=1.0, rebin_every=10)
COMPACT_KW = dict(num_steps=20, max_lr=3e-3, rebin_every=0)
OVERFLOW_CAP = 96  # under the (1 data, 0 tile) shard's start-pose load (98) only


@pytest.fixture(scope="module")
def scene():
    """The rig and scene: link poses of 4 frames from JAX's FK, the GT pose,
    and target masks rendered by the port's full-height renderers (both
    packages get them as numpy arrays)."""
    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(MINI_URDF)
        path = f.name
    model = parse_urdf(path)
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    mesh_list = [meshes[n] for n in LINKS]
    qs = jnp.linspace(-0.5, 0.5, 4 * chain.n_dof).reshape(4, chain.n_dof)
    li = jnp.asarray([chain.link_index(n) for n in LINKS])
    lp = np.array(jax.vmap(chain.fk)(qs)[:, li])
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = np.asarray(jse3.log(jnp.asarray(Tc)))

    def render(cfg, xi, lpx):
        r = TR(mesh_list, H, W, tile=TTC(**cfg), device="cpu")
        with torch.no_grad():
            return r.silhouette(tse3.exp(torch.from_numpy(xi)), torch.from_numpy(lpx),
                                torch.from_numpy(K)).numpy()

    # the loss scene (test_sharding's): 3 frames, target at the pose + 0.01
    return dict(mesh_list=mesh_list, lp=lp, Tc=Tc, gt=gt,
                target_u=render(RIG, gt, lp), target_d=render(DENSE, gt, lp),
                target3=render(RIG, gt + np.float32(0.01), lp[:3]))


def _jr(scene, cfg, h):
    return JR(scene["mesh_list"], h, W, tile=JTC(**cfg))


def _port(scene, cfg, h):
    return TR(scene["mesh_list"], h, W, tile=TTC(**cfg), device="cpu")


WORKER = r'''
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
rank, rdv, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from easyhec_torch.parallel import init_distributed, make_mesh
from easyhec_torch.parallel import comm, sharding as sh
from easyhec_torch.models import calib
from easyhec_torch.models.calib import BinOverflowError
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.utils import cuda_graph
from easyhec_torch.geometry import se3
from easyhec_torch.robot.mesh import TriMesh
init_distributed(rdv, num_processes=4, process_id=rank, backend="gloo")
scans = []  # each scan sharded_calibrate builds: whether it was captured
cuda_graph.captures = lambda device: True  # the one predicate says CUDA
class CountedScan(calib._Scan):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        scans.append(False)
    def capture(self, pool=None):  # recorded; the scan runs eagerly
        scans[-1] = True
calib._Scan = CountedScan
inp = pickle.loads(open(d + "/in.pkl", "rb").read())
W, BAND_H = inp["W"], inp["BAND_H"]
meshes = [TriMesh(v, f) for v, f in inp["meshes"]]
def band(cfg):
    return RobotRenderer(meshes, BAND_H, W, tile=TileConfig(**cfg), device="cpu")
out = dict(rank=rank)
errs = []
for shape in ((4, 2), (1, 1)):
    try:
        make_mesh(*shape)
    except ValueError as e:
        errs.append(str(e))
out["mesh_errors"] = errs
mesh = make_mesh(2, 2)
out["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("tile"))
lp, K = inp["lp"], inp["K"]
ru = band(inp["RIG"])
out["sil"] = sh.sharded_silhouette(ru, mesh, BAND_H)(inp["Tc"], lp, K).numpy()
lp3, w3 = sh.pad_frames(lp[:3], 2)
m3, _ = sh.pad_frames(inp["target3"], 2)
dof = torch.tensor(inp["gt"], requires_grad=True)
loss = sh.sharded_mask_loss(ru, mesh, BAND_H)(dof, lp3, K, m3, w3)
loss.backward()
out["loss3"], out["grad3"] = loss.item(), dof.grad.numpy()
init = inp["gt"] + inp["OFFSET"]
for name, cfg, target, kw in (("dense", inp["DENSE"], inp["target_d"], inp["DENSE_KW"]),
                              ("compact", inp["COMPACT"], inp["target_d"], inp["COMPACT_KW"])):
    scans.clear()
    res = sh.sharded_calibrate(init, band(cfg), mesh, lp, K, target, chunk=25, **kw)
    out[name] = [t.numpy() for t in res]
    out["scans_" + name] = list(scans)
for fc in (0, 1):
    scans.clear()
    res = sh.sharded_calibrate(init, ru, mesh, lp, K, inp["target_u"], num_steps=20,
                               chunk=10, frame_chunk=fc)
    out[f"fc{{fc}}"] = [t.numpy() for t in res]
    out[f"scans_fc{{fc}}"] = list(scans)
out["backend"] = torch.distributed.get_backend()
rov = band(dict(inp["RIG"], capacity=inp["OVERFLOW_CAP"]))
di, ti = out["coords"]
x0 = torch.tensor(inp["gt"] + 2 * inp["OFFSET"])
st = rov.bin_state(se3.exp(x0), torch.tensor(lp[2 * di:2 * di + 2]),
                   sh._band_K(torch.tensor(K), ti * BAND_H))
out["local_overflow"] = bool(st.overflow.any())
try:
    sh.sharded_calibrate(x0.numpy(), rov, mesh, lp, K, inp["target_u"], num_steps=10,
                         chunk=5)
    out["raised"] = None
except BinOverflowError as e:
    out["raised"] = str(e)
out["gather"] = comm.all_gather_arrays(np.arange(3.0) + rank)
out["objects"] = comm.all_gather_objects({{"rank": rank, "pad": "x" * (100 * rank)}})
out["reduced"] = comm.reduce_dict({{"loss": rank + 0.5, "iou": 1.0}})
out["summed"] = comm.reduce_dict({{"loss": rank + 0.5}}, average=False)
out["count"], out["index"], out["main"] = (comm.process_count(), comm.process_index(),
                                           comm.is_main_process())
comm.sync()
open(d + f"/out{{rank}}.pkl", "wb").write(pickle.dumps(out))
print("WORKER_OK", rank)
'''


class _Workers:
    """The 4 port ranks, started when the module's first test asks for them
    and read once."""

    def __init__(self, scene, tmp):
        inp = dict(W=W, BAND_H=BAND_H, K=K, RIG=RIG, DENSE=DENSE, COMPACT=COMPACT,
                   OFFSET=OFFSET, DENSE_KW=DENSE_KW, COMPACT_KW=COMPACT_KW,
                   OVERFLOW_CAP=OVERFLOW_CAP,
                   meshes=[(m.vertices, m.faces) for m in scene["mesh_list"]],
                   **{k: scene[k] for k in ("lp", "Tc", "gt", "target_u",
                                            "target_d", "target3")})
        (tmp / "in.pkl").write_bytes(pickle.dumps(inp))
        script = tmp / "worker.py"
        script.write_text(WORKER.format(repo=str(ROOT)))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.tmp = tmp
        self.procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), f"file://{tmp / 'rdv'}", str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(ROOT))
            for r in range(4)]
        self._out = None

    def out(self):
        if self._out is None:
            logs = []
            try:
                logs = [p.communicate(timeout=300)[0].decode() for p in self.procs]
            finally:
                for p in self.procs:  # a hung rank never outlives the module
                    p.kill()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0 and f"WORKER_OK {r}" in log, \
                    f"rank {r} failed:\n{log[-4000:]}"
            self._out = [pickle.loads((self.tmp / f"out{r}.pkl").read_bytes())
                         for r in range(4)]
        return self._out


@pytest.fixture(scope="module", autouse=True)
def ranks(scene, tmp_path_factory):
    """Started with the module's first test, so the ranks run while the
    JAX side computes."""
    w = _Workers(scene, tmp_path_factory.mktemp("ranks"))
    yield w
    for p in w.procs:
        p.kill()


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(N_DATA, N_TILE)


def test_pad_frames_and_band_K_bit_exact():
    rng = np.random.default_rng(0)
    for b, n in ((3, 2), (4, 2), (5, 4), (1, 1)):
        a = rng.normal(size=(b, 2, 3)).astype(np.float32)
        (pa, wa), (pb, wb) = tpar.pad_frames(a, n), jpar.pad_frames(a, n)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(wa, wb)
        assert pa.dtype == pb.dtype and wa.dtype == wb.dtype
    for y0 in (0.0, 32.0, 540.0):
        kj = np.asarray(jsh._band_K(jnp.asarray(K), jnp.float32(y0)))
        kt = tsh._band_K(torch.from_numpy(K), y0).numpy()
        np.testing.assert_array_equal(kt, kj)


def test_opt_scan_combine_hook():
    """combine's route (a (objective, true loss) pair and a reducer) with an
    identity reducer runs the combine=None trajectory exactly."""
    A = torch.tensor([1.0, 2.0, 0.5, 3.0, 1.5, 0.25])
    opt = t_make_optimizer("adam", max_lr=1e-2, scheduler="constant")

    def plain(d, _):
        return torch.sum(A * (d - 0.3) ** 2)

    def pair(d, _):
        v = plain(d, None)
        return v, v.detach()

    d0 = torch.zeros(6)
    a = tc.opt_scan(d0, opt.init(d0), opt, plain, None, 7, 0)
    seen = []

    def combine(t, g):
        seen.append(t.requires_grad)
        return t, g

    b = tc.opt_scan(d0, opt.init(d0), opt, pair, None, 7, 0, combine=combine)
    for x, y in zip(a[:4:2] + a[2:4], b[:4:2] + b[2:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert seen == [False] * 7 and b[4:] == (False, 0)


def test_comm_single_process_fallbacks():
    assert tcomm.process_count() == 1 and tcomm.process_index() == 0
    assert tcomm.is_main_process()
    tcomm.sync()
    g = tcomm.all_gather_arrays(np.arange(3.0))
    np.testing.assert_array_equal(g, jcomm.all_gather_arrays(np.arange(3.0)))
    assert tcomm.all_gather_objects({"a": 1, "b": [2, 3]}) == [{"a": 1, "b": [2, 3]}]
    red = {"loss": 2.0, "iou": 0.5}
    assert tcomm.reduce_dict(red) == jcomm.reduce_dict(red) == red


def test_single_process_mesh_and_init(monkeypatch):
    for k in ("EASYHEC_COORDINATOR", "EASYHEC_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    assert tpar.maybe_init_from_env() is False
    m = tpar.make_mesh(1, 1)
    assert (m.size(0), m.size(1), m.get_local_rank("tile")) == (1, 1, 0)
    for shape in ((2, 1), (2, 2)):
        with pytest.raises(ValueError, match=f"need {shape[0] * shape[1]} devices, have 1"):
            tpar.make_mesh(*shape)


def test_make_mesh_devices_stand_in():
    """make_mesh(devices=...) without a process group: the (1, 1) stand-in
    over [0] (extra entries ignored, as JAX takes the first devices), JAX's
    error when too few are given, and a refusal of a rank outside the
    world."""
    for devices in ([0], (0, 5), np.array([0])):
        m = tpar.make_mesh(1, 1, devices=devices)
        assert (m.size(0), m.size(1), m.get_local_rank("data")) == (1, 1, 0)
    for make in (tpar.make_mesh, jpar.make_mesh):
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            make(1, 1, devices=[])
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tpar.make_mesh(2, 1, devices=[0, 1])
    with pytest.raises(ValueError, match="not the ranks"):
        tpar.make_mesh(1, 1, devices=[3])


MESH_WORKER = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
rank, rdv, d = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from easyhec_torch.parallel import init_distributed, make_mesh, sharded_silhouette
from easyhec_torch.geometry import se3
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import make_box
init_distributed(rdv, num_processes=2, process_id=rank, backend="gloo")
out = dict(layouts={{}}, errors=[])
for key, shape, devices in (("none", (2, 1), None), ("swap", (2, 1), [1, 0]),
                            ("long", (2, 1), [1, 0, 7]), ("tile", (1, 2), [1, 0])):
    m = make_mesh(*shape, devices=devices)
    out["layouts"][key] = dict(mesh=m.mesh.tolist(), coords=m.get_coordinate())
for shape, devices in (((2, 1), [0]), ((2, 1), [0, 0]), ((1, 1), [0])):
    try:
        make_mesh(*shape, devices=devices)
    except ValueError as e:
        out["errors"].append(str(e))
r = RobotRenderer([make_box((0.3, 0.2, 0.25), center=(0.05, 0.15, 0.0))], 16, 32,
                  tile=TileConfig(tile_h=16, tile_w=32, capacity=128), device="cpu")
Tc = se3.exp(torch.tensor([0.02, -0.01, 1.5, 0.3, -0.2, 0.1]))
lp = np.repeat(np.eye(4, dtype=np.float32)[None, None], 2, 0)
K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)
sil = [sharded_silhouette(r, make_mesh(1, 2, devices=dv), 16)(Tc, lp, K).numpy()
       for dv in ([0, 1], [1, 0])]
out["sil_equal"] = bool((sil[0] == sil[1]).all())
out["band_mass"] = [float(sil[0][:, :16].sum()), float(sil[0][:, 16:].sum())]
open(d + f"/mesh{{rank}}.json", "w").write(json.dumps(out))
print("MESH_OK", rank)
'''


def test_make_mesh_devices_two_ranks(tmp_path):
    """make_mesh(devices=...) on a 2-rank gloo group: the given ranks laid
    out row-major as JAX lays out its devices, the errors, and the same
    sharded silhouette whichever rank renders which band."""
    script = tmp_path / "mesh_worker.py"
    script.write_text(MESH_WORKER.format(repo=str(ROOT)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), f"file://{tmp_path / 'rdv'}",
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(ROOT)) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"MESH_OK {r}" in log, log[-4000:]
    outs = [json.loads((tmp_path / f"mesh{r}.json").read_text()) for r in range(2)]
    jd = jax.devices()
    for key, shape, order in (("none", (2, 1), [0, 1]), ("swap", (2, 1), [1, 0]),
                              ("long", (2, 1), [1, 0, 7]), ("tile", (1, 2), [1, 0])):
        jm = jpar.make_mesh(*shape, devices=[jd[i] for i in order])
        want = np.vectorize(lambda dev: dev.id)(jm.devices).tolist()
        for r, o in enumerate(outs):
            lay = o["layouts"][key]
            assert lay["mesh"] == want, key
            pos = np.argwhere(np.array(want) == r)[0].tolist()
            assert lay["coords"] == pos, key
    for o in outs:
        assert o["errors"][0] == "need 2 devices, have 1"
        assert "not the ranks" in o["errors"][1]
        assert "world of 2" in o["errors"][2]
        top, bottom = o["band_mass"]  # bands that differ, so a swap would show
        assert o["sil_equal"] and top > 10.0 and abs(top - bottom) > 10.0


def test_one_rank_mesh_runs_calibrate(scene):
    """On the (1, 1) mesh without a process group, sharded_calibrate is the
    one-device calibrate with the sharded loss's bookkeeping: at chunk 50
    (windows of 10 that end on the chunk) the same steps, the same poses."""
    full = _port(scene, DENSE, H)
    init = scene["gt"] + OFFSET
    kw = dict(DENSE_KW, num_steps=30)
    ref = tc.calibrate(init, full, scene["lp"], K, scene["target_d"], **kw)
    dof, losses, history = tpar.sharded_calibrate(init, full, tpar.make_mesh(1, 1),
                                                  scene["lp"], K, scene["target_d"],
                                                  chunk=50, **kw)
    np.testing.assert_allclose(losses.numpy(), ref.losses, rtol=1e-3)
    np.testing.assert_allclose(dof.numpy(), ref.dof, atol=1e-4)
    assert history.shape == (30, 6)
    with pytest.raises(ValueError, match="must equal band height"):
        tpar.sharded_calibrate(init, _port(scene, DENSE, BAND_H), tpar.make_mesh(1, 1),
                               scene["lp"], K, scene["target_d"], num_steps=1)


def test_one_rank_mesh_builds_one_scan_per_call(scene, monkeypatch):
    """sharded_calibrate sets its scan up once per call and runs it in every
    chunk, as calibrate does: 30 steps in 3 chunks of 10 build one scan, and
    their trace equals the same call's in one chunk of 30 bit for bit (fixed
    windows of 10, so the two rebin at the same steps). Captured where the
    one predicate says CUDA: a one-rank mesh issues no collective (NCCL's
    and gloo's 2x2 meshes are tests/test_torch_capture_rule.py's cases)."""
    built = []

    class CountedScan(tc._Scan):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(False)

        def capture(self, pool=None):  # recorded; the scan runs eagerly
            built[-1] = True

    monkeypatch.setattr(tc, "_Scan", CountedScan)
    monkeypatch.setattr(cuda_graph, "captures", lambda device: True)
    full = _port(scene, DENSE, H)
    init = scene["gt"] + OFFSET
    kw = dict(DENSE_KW, num_steps=30)
    out = {}
    for chunk in (10, 30):
        built.clear()
        out[chunk] = tpar.sharded_calibrate(init, full, tpar.make_mesh(1, 1), scene["lp"], K,
                                            scene["target_d"], chunk=chunk, **kw)
        assert built == [True]  # one scan, captured
    for a, b in zip(out[10], out[30]):
        assert torch.equal(a, b)
    assert out[10][1].shape == (30,) and out[10][1][-1] < out[10][1][0]


def test_sharded_calibrate_one_scan_per_call_on_gloo(ranks):
    """On the 2x2 gloo mesh every sharded_calibrate call builds one scan,
    whatever its chunks (dense: 60 steps in chunks of 25; the frame-chunked
    and unchunked runs: 20 in chunks of 10), eager even where the one
    predicate (utils.cuda_graph.captures) says CUDA: gloo's collectives
    cannot be captured."""
    for o in ranks.out():
        for key in ("dense", "compact", "fc0", "fc1"):
            assert o["scans_" + key] == [False], key
        assert o["backend"] == "gloo"


def test_dense_sharded_calibrate_matches_jax(scene, ranks, jmesh):
    init = scene["gt"] + OFFSET
    jdof, jl, jh = jpar.sharded_calibrate(init, _jr(scene, DENSE, BAND_H), jmesh,
                                          scene["lp"], K, scene["target_d"], chunk=25,
                                          **DENSE_KW)
    dof, losses, history = ranks.out()[0]["dense"]
    np.testing.assert_allclose(losses[:10], np.asarray(jl)[:10], rtol=3e-3, atol=1e-3)
    np.testing.assert_allclose(dof, np.asarray(jdof), atol=5e-3)
    assert history.shape == np.asarray(jh).shape == (60, 6)
    assert losses[-1] < 2.0 * max(float(np.asarray(jl)[-1]), 0.5)


def test_compact_adaptive_sharded_calibrate_matches_port(scene, ranks):
    """Compact chunks with the boundary-prefix backward map and adaptive
    rebinning, against the port's own one-device calibrate (JAX's compact
    kernels run only in its slow tier: the next test)."""
    ref = tc.calibrate(scene["gt"] + OFFSET, _port(scene, COMPACT, H), scene["lp"], K,
                       scene["target_d"], **COMPACT_KW)
    dof, losses, history = ranks.out()[0]["compact"]
    np.testing.assert_allclose(losses[:10], ref.losses[:10], rtol=3e-3, atol=1e-3)
    np.testing.assert_allclose(dof, ref.dof, atol=5e-3)
    assert history.shape == (20, 6) and losses[-1] < losses[0]


@pytest.mark.slow
def test_compact_sharded_calibrate_matches_jax(scene, ranks, jmesh):
    init = scene["gt"] + OFFSET
    jdof, jl, _ = jpar.sharded_calibrate(init, _jr(scene, COMPACT, BAND_H), jmesh,
                                         scene["lp"], K, scene["target_d"], chunk=25,
                                         **COMPACT_KW)
    dof, losses, _ = ranks.out()[0]["compact"]
    np.testing.assert_allclose(losses[:10], np.asarray(jl)[:10], rtol=3e-3, atol=1e-3)
    np.testing.assert_allclose(dof, np.asarray(jdof), atol=5e-3)


def test_ranks_layout_and_mesh_errors(ranks):
    outs = ranks.out()
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for o in outs:
        assert o["mesh_errors"][0] == "need 8 devices, have 4"
        assert "world of 4" in o["mesh_errors"][1]


def test_sharded_silhouette_matches_full(scene, ranks):
    """Every rank's gathered bands against the one-device silhouette of
    both packages (JAX's sharded render equals its one-device render at
    1e-4: its slow tier, and test_..._match_jax_sharded below)."""
    args = (scene["Tc"], scene["lp"], K)
    jfull = np.asarray(_jr(scene, RIG, H).silhouette(*map(jnp.asarray, args)))
    with torch.no_grad():
        full = _port(scene, RIG, H).silhouette(*map(torch.from_numpy, args)).numpy()
    assert full.max() == 1.0  # robot visible
    for o in ranks.out():
        assert o["sil"].shape == (4, H, W)
        np.testing.assert_allclose(o["sil"], jfull, atol=1e-4)
        np.testing.assert_allclose(o["sil"], full, atol=1e-4)


@pytest.mark.slow
def test_sharded_silhouette_and_loss_match_jax_sharded(scene, ranks, jmesh):
    render = jpar.sharded_silhouette(_jr(scene, RIG, BAND_H), jmesh, BAND_H)
    jout = np.asarray(render(jnp.asarray(scene["Tc"]), jnp.asarray(scene["lp"]),
                             jnp.asarray(K)))
    lp_p, w = jpar.pad_frames(scene["lp"][:3], N_DATA)
    m_p, _ = jpar.pad_frames(scene["target3"], N_DATA)
    jl = float(jpar.sharded_mask_loss(_jr(scene, RIG, BAND_H), jmesh, BAND_H)(
        jnp.asarray(scene["gt"]),
        jax.device_put(jnp.asarray(lp_p), NamedSharding(jmesh, P("data"))),
        jnp.asarray(K),
        jax.device_put(jnp.asarray(m_p), NamedSharding(jmesh, P("data", "tile"))),
        jax.device_put(jnp.asarray(w), NamedSharding(jmesh, P("data")))))
    for o in ranks.out():
        np.testing.assert_allclose(o["sil"], jout, atol=1e-4)
        np.testing.assert_allclose(o["loss3"], jl, rtol=1e-4)


def test_sharded_mask_loss_and_gradient(scene, ranks):
    """B = 3 over 2 data ranks (a padded frame of weight 0): the loss against
    both packages' one-device mask_loss; the gradient on every rank against
    the port's one-device gradient (the true global gradient)."""
    gt, lp3, t3 = scene["gt"], scene["lp"][:3], scene["target3"]
    jl = float(jc.mask_loss(jnp.asarray(gt), _jr(scene, RIG, H), jnp.asarray(lp3),
                            jnp.asarray(K), jnp.asarray(t3)))
    d = torch.tensor(gt, requires_grad=True)
    ref = tc.mask_loss(d, _port(scene, RIG, H), torch.from_numpy(lp3), torch.from_numpy(K),
                       torch.from_numpy(t3))
    (g_ref,) = torch.autograd.grad(ref, d)
    assert np.abs(g_ref.numpy()).max() > 0
    for o in ranks.out():
        np.testing.assert_allclose(o["loss3"], jl, rtol=1e-4)
        np.testing.assert_allclose(o["loss3"], ref.item(), rtol=1e-4)
        np.testing.assert_allclose(o["grad3"], g_ref.numpy(), rtol=2e-3, atol=1e-2)


def test_frame_chunked_matches_unchunked(ranks):
    o = ranks.out()[0]
    (d0, l0, _), (d1, l1, _) = o["fc0"], o["fc1"]
    np.testing.assert_allclose(l1, l0, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(d1, d0, atol=1e-5)
    assert l0[-1] < l0[0]


def test_every_rank_bit_identical(ranks):
    outs = ranks.out()
    for o in outs[1:]:
        for key in ("dense", "compact", "fc0", "fc1"):
            for a, b in zip(o[key], outs[0][key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
        assert o["loss3"] == outs[0]["loss3"]
        np.testing.assert_array_equal(o["grad3"], outs[0]["grad3"])


def test_one_shard_overflow_raises_on_every_rank(ranks):
    """Only the (1, 0) shard overflows cap 96 at the start pose; every rank
    raises BinOverflowError after the same chunk, and none hangs (the
    workers ran to their end within the fixture's timeout)."""
    outs = ranks.out()
    assert [o["local_overflow"] for o in outs] == [False, False, True, False]
    msgs = {o["raised"] for o in outs}
    assert len(msgs) == 1 and "bin overflow at step ~5" in msgs.pop()


def test_comm_across_ranks(ranks):
    outs = ranks.out()
    for o in outs:
        np.testing.assert_array_equal(o["gather"], np.arange(3.0)[None] + np.arange(4)[:, None])
        assert o["objects"] == [{"rank": r, "pad": "x" * (100 * r)} for r in range(4)]
        assert o["reduced"] == {"iou": 1.0, "loss": 2.0}
        assert o["summed"] == {"loss": 8.0}
        assert o["count"] == 4
    assert [o["index"] for o in outs] == [0, 1, 2, 3]
    assert [o["main"] for o in outs] == [True, False, False, False]


# ---- the CLI under EASYHEC_* env, 2 gloo processes on the CPU ---------------

SIM = str(ROOT / "configs" / "sim_mini.yaml")
CLI_H, CLI_W = 120, 160


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_run_two_processes_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = j_load(SIM, [f"model.H={CLI_H}", f"model.W={CLI_W}"])
    rt = j_build_runtime(cfg)
    fx = 1.2 * max(CLI_H, CLI_W)
    Kc = np.array([[fx, 0, CLI_W / 2], [0, fx, CLI_H / 2], [0, 0, 1]], np.float32)
    Tc = default_camera()
    generate_dataset(tmp_path / "data", rt.chain, rt.renderer, rt.link_names, Tc, Kc,
                     n_frames=3, seed=0)
    xi = np.asarray(jse3.log(jnp.asarray(Tc, jnp.float32)))
    xi = xi + np.array([0.04, -0.03, 0.03, 0.04, -0.035, 0.03], np.float32)
    init = np.asarray(jse3.exp(jnp.asarray(xi))).tolist()
    opts = [f"model.H={CLI_H}", f"model.W={CLI_W}", "solver.num_epochs=10",
            "solver.log_interval=10", f"dataset.data_dir={tmp_path / 'data'}",
            f"model.init_Tc_c2b={init}"]
    env = dict(os.environ, EASYHEC_COORDINATOR=f"127.0.0.1:{_free_port()}",
               EASYHEC_NUM_PROCESSES="2", EASYHEC_CPU_COLLECTIVES="gloo")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "easyhec_torch.cli.run", "-c", SIM, "--device", "cpu", *opts,
         f"output_dir={tmp_path / f'run{i}'}"],
        env=dict(env, EASYHEC_PROCESS_ID=str(i)), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0 and "solved Tc_c2b" in log, log[-3000:]

    for name in ("easyhec_tpu", "easyhec_torch"):  # a fresh log.txt for the JAX run
        monkeypatch.setattr(logging.getLogger(name), "handlers", [])
    jres = j_run(j_load(SIM, opts + [f"output_dir={tmp_path / 'jax'}"]))
    for i in range(2):
        run = tmp_path / f"run{i}"
        np.testing.assert_allclose(np.loadtxt(run / "Tc_c2b.txt"), np.asarray(jres.Tc_c2b),
                                   atol=1e-4)
        fin = np.load(run / "checkpoints" / "final.npz")
        np.testing.assert_allclose(fin["losses"], jres.losses, rtol=1e-3)
        np.testing.assert_allclose(fin["dof"], jres.dof, atol=1e-4)
