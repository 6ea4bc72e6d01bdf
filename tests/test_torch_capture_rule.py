"""Where easyhec_torch captures a CUDA graph, held on the CPU.

One predicate, ``utils.cuda_graph.captures(device)``, says whether work on a
device runs as CUDA graphs; each caller adds the facts of its own inputs
that rule a graph out, and every graph is made by one routine,
``utils.cuda_graph.capture``. Here the predicate is patched to say CUDA, and
the warm-up and the two graph classes are replaced by stand-ins that record
each capture and replay the captured functions eagerly, so every call runs
to its end. One case per row of the capture rule (route x mesh x hook):
each records which captures it reached, in order, and gives the result of
the same call with the predicate as it is (eager on the CPU) bit for bit.

    calibrate, calibrate_multires   kernel route with reusable bin states
                                    (count binner, or fused): a CondGraph;
                                    top-k binner, brute, use_pallas=False:
                                    eager
    sharded_calibrate               as calibrate, and frame_chunk <= 0, and
                                    a one-rank mesh or NCCL; gloo on a 2x2
                                    mesh: eager
    opt_scan                        no combine hook: a Graph without bin
                                    states, else a CondGraph; a hook: eager
    global_search_init              the scoring renderer's kernel route:
                                    three Graphs, the later two in the
                                    sweep's pool; brute, use_pallas=False:
                                    eager
    find_lr                         a Graph
    SpaceExplorer._score            the state-driven batch (exact, shared,
                                    counted): a Graph; the stateless loop
                                    (top-k binner): eager

The 2x2 meshes are this process as rank (0, 0) of a mesh whose collectives
are identities, its backend reported as gloo or NCCL.
"""
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from easyhec_torch.geometry import se3
from easyhec_torch.models import calib, pose_init
from easyhec_torch.models.explorer import SpaceExplorer, draw_hypotheses_and_candidates
from easyhec_torch.parallel import make_mesh, sharded_calibrate, sharding
from easyhec_torch.render import RobotRenderer, TileConfig
from easyhec_torch.robot import build_chain, load_link_meshes, parse_urdf
from easyhec_torch.solver.lr_finder import find_lr
from easyhec_torch.solver.optim import make_optimizer
from easyhec_torch.utils import cuda_graph
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
H, W, BAND_H = 64, 64, 32
LINKS = ["base", "upper", "fore"]
UNFUSED = dict(tile_h=16, tile_w=32, capacity=128, margin=2.0)
DENSE = dict(UNFUSED, fused=True, bin_big_k=128, bwd_band_only=True)
COMPACT = dict(DENSE, bin_subsort_rows=True, compact_chunks=24)
ROUTES = {
    "compact": (dict(COMPACT), "tiled"),
    "dense": (dict(DENSE), "tiled"),
    "unfused": (dict(UNFUSED), "tiled"),
    "topk": (dict(UNFUSED, binner="topk"), "tiled"),
    "brute": (dict(UNFUSED), "brute"),
    "plain": (dict(UNFUSED, use_pallas=False), "tiled"),
}
OFFSET = np.array([0.01, -0.01, 0.01, 0.01, -0.005, 0.01], np.float32)
STEPS = dict(num_steps=6, max_lr=3e-3)


@pytest.fixture(scope="module")
def scene():
    model = parse_urdf(ROOT / "assets" / "mini_arm.urdf")
    chain = build_chain(model)
    meshes = load_link_meshes(model, link_names=LINKS)
    idx = [chain.link_names.index(n) for n in LINKS]
    lp = np.stack([chain.fk(torch.tensor(q))[idx].numpy()
                   for q in ([0.3, -0.4], [-0.2, 0.5])]).astype(np.float32)
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    Tc = np.eye(4, dtype=np.float32)
    Tc[2, 3] = 1.2
    gt = se3.log(torch.from_numpy(Tc)).numpy()
    r = _renderer(dict(mesh_list=[meshes[n] for n in LINKS]), "unfused", H)
    with torch.no_grad():
        sil = r.silhouette(torch.from_numpy(Tc), torch.from_numpy(lp), torch.from_numpy(K))
    return dict(chain=chain, mesh_list=[meshes[n] for n in LINKS], lp=lp, K=K, gt=gt,
                target=(sil > 0.5).float().numpy())


def _renderer(scene, route, h=H):
    tile, mode = ROUTES[route]
    return RobotRenderer(scene["mesh_list"], h, W, tile=TileConfig(**tile), mode=mode,
                         device="cpu")


class _Mesh2x2(sharding._LocalMesh):
    """Rank (0, 0) of a 2x2 mesh, as sharding reads a mesh."""

    shape = (2, 2)

    def size(self, mesh_dim=None) -> int:
        return 2 if mesh_dim is not None else 4

    def get_group(self, name):
        return None


def _calibrate(scene, route):
    return calib.calibrate(scene["gt"] + OFFSET, _renderer(scene, route), scene["lp"],
                           scene["K"], scene["target"], rebin_every=0, on_overflow="ignore",
                           **STEPS)


def _multires(scene, route):
    renderers = {1: _renderer(scene, route),
                 2: RobotRenderer(scene["mesh_list"], H // 2, W // 2,
                                  tile=TileConfig(**ROUTES[route][0]), device="cpu")}
    return calib.calibrate_multires(scene["gt"] + OFFSET, renderers, scene["lp"], scene["K"],
                                    scene["target"], {2: 3, 1: 3}, max_lr=3e-3)


def _sharded(scene, route, mesh="one", frame_chunk=0, monkeypatch=None):
    if mesh == "one":
        m, r = make_mesh(1, 1), _renderer(scene, route)
    else:
        monkeypatch.setattr(sharding, "_all_reduce", lambda t, n, group=None, op=None: t)
        monkeypatch.setattr(sharding.dist, "get_backend", lambda group=None: mesh)
        m, r = _Mesh2x2(), _renderer(scene, route, BAND_H)
    return sharded_calibrate(scene["gt"] + OFFSET, r, m, scene["lp"], scene["K"],
                             scene["target"], rebin_every=0, chunk=4, frame_chunk=frame_chunk,
                             on_overflow="ignore", **STEPS)


def _opt_scan(scene, rebin_every, hook=False):
    r = _renderer(scene, "compact")
    t = {k: torch.from_numpy(scene[k]) for k in ("lp", "K", "target")}
    ref_tiles = calib.tile_masks(t["target"], r)

    def loss_of(d, state):
        loss = calib.mask_loss(d, r, t["lp"], t["K"], t["target"], bin_state=state,
                               ref_tiles=ref_tiles)
        return (loss, loss) if hook else loss

    def bin_state_of(d):
        return r.bin_state(se3.exp(d), t["lp"], t["K"])

    opt = make_optimizer("adam", max_lr=3e-3, total_steps=6)
    d0 = torch.from_numpy(scene["gt"] + OFFSET)
    return calib.opt_scan(d0, opt.init(d0), opt, loss_of, bin_state_of if rebin_every else None,
                          6, rebin_every, combine=(lambda tl, g: (tl, g)) if hook else None)


def _search(scene, route):
    res = pose_init.global_search_init(_renderer(scene, route), scene["lp"], scene["K"],
                                       scene["target"], radii=(1.0, 1.3), n_dirs=5, n_roll=2,
                                       downscale=2, topk=3, refine_steps=3)
    return res.Tc_c2b, res.score, res.scores, res.tiles_at_cap


def _find_lr(scene):
    r = _renderer(scene, "compact")
    t = {k: torch.from_numpy(scene[k]) for k in ("lp", "K", "target")}
    d0 = torch.from_numpy(scene["gt"] + OFFSET)
    st = r.bin_state(se3.exp(d0), t["lp"], t["K"])
    ref_tiles = calib.tile_masks(t["target"], r)
    res = find_lr(lambda d: calib.mask_loss(d, r, t["lp"], t["K"], t["target"], bin_state=st,
                                            ref_tiles=ref_tiles), d0, 1e-5, 1e-1, 5)
    return res.losses, res.suggestion


def _score(scene, route, shared=False):
    chain = scene["chain"]
    lim = chain.joint_limits * np.float32(0.9)
    _, q = draw_hypotheses_and_candidates(0, 1, 1, 7, lim[:, 0], lim[:, 1])
    hyp = (scene["gt"] + np.random.default_rng(0).normal(0, 0.01, (3, 6))).astype(np.float32)
    e = SpaceExplorer(chain, _renderer(scene, route), LINKS, score_batch=3, max_dist=None)
    return (*e._score(q, hyp, scene["K"], shared=shared), e.last_bin_states)


SHARED = "pool of the sweep"
CASES = {
    # calibrate and calibrate_multires: reuse_bins_ok(renderer)
    "calibrate-compact": (lambda s, mp: _calibrate(s, "compact"), ["cond"]),
    "calibrate-dense": (lambda s, mp: _calibrate(s, "dense"), ["cond"]),
    "calibrate-unfused": (lambda s, mp: _calibrate(s, "unfused"), ["cond"]),
    "calibrate-topk": (lambda s, mp: _calibrate(s, "topk"), []),
    "calibrate-brute": (lambda s, mp: _calibrate(s, "brute"), []),
    "calibrate-plain": (lambda s, mp: _calibrate(s, "plain"), []),
    "calibrate_multires-compact": (lambda s, mp: _multires(s, "compact"), ["cond", "cond"]),
    "calibrate_multires-topk": (lambda s, mp: _multires(s, "topk"), []),
    # sharded_calibrate: as calibrate, frame_chunk <= 0, one rank or NCCL
    "sharded-one-rank": (lambda s, mp: _sharded(s, "compact"), ["cond"]),
    "sharded-nccl-2x2": (lambda s, mp: _sharded(s, "compact", "nccl", monkeypatch=mp),
                         ["cond"]),
    "sharded-gloo-2x2": (lambda s, mp: _sharded(s, "compact", "gloo", monkeypatch=mp), []),
    "sharded-frame-chunk": (lambda s, mp: _sharded(s, "unfused", frame_chunk=1), []),
    "sharded-topk": (lambda s, mp: _sharded(s, "topk"), []),
    # opt_scan: no combine hook
    "opt_scan-stateless": (lambda s, mp: _opt_scan(s, 0), [("graph", None)]),
    "opt_scan-every3": (lambda s, mp: _opt_scan(s, 3), ["cond"]),
    "opt_scan-hook": (lambda s, mp: _opt_scan(s, 3, hook=True), []),
    # global_search_init: the scoring renderer's kernel route
    "search-kernel": (lambda s, mp: _search(s, "unfused"),
                      [("graph", None), ("graph", SHARED), ("graph", SHARED)]),
    "search-brute": (lambda s, mp: _search(s, "brute"), []),
    "search-plain": (lambda s, mp: _search(s, "plain"), []),
    # find_lr: always
    "find_lr": (lambda s, mp: _find_lr(s), [("graph", None)]),
    # SpaceExplorer._score: the state-driven batch
    "score-exact": (lambda s, mp: _score(s, "compact"), [("graph", None)]),
    "score-shared": (lambda s, mp: _score(s, "compact", shared=True), [("graph", None)]),
    "score-counted": (lambda s, mp: _score(s, "unfused"), [("graph", None)]),
    "score-stateless": (lambda s, mp: _score(s, "topk"), []),
}


def _stand_ins(monkeypatch):
    """The predicate says CUDA; the warm-up runs on the CPU; Graph and
    CondGraph record their capture and replay eagerly. -> the list of
    captures: ("graph", pool) or "cond"."""
    made = []

    class Graph:
        def __init__(self, fn, counters, pool=None):
            made.append(("graph", pool))
            self.fn, self.graph = fn, self

        def replay(self):
            self.fn()

        def pool(self):
            return SHARED

    class CondGraph:
        def __init__(self, flag, body, tail, counters):
            made.append("cond")
            self.flag, self.body, self.tail = flag, body, tail

        def replay(self):
            if bool(self.flag):
                self.body()
            self.tail()

        def taken(self, n):
            pass

    monkeypatch.setattr(cuda_graph, "captures", lambda device: True)
    monkeypatch.setattr(cuda_graph, "warm_up", lambda fn, counters, dev: counters.moved_by(fn))
    monkeypatch.setattr(cuda_graph, "Graph", Graph)
    monkeypatch.setattr(cuda_graph, "CondGraph", CondGraph)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return made


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, calib.CalibResult):
        return all(_same(getattr(a, k), getattr(b, k))
                   for k in ("dof", "losses", "history", "overflow", "rebins"))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("case", list(CASES))
def test_capture_rule(scene, case, monkeypatch):
    """The call reaches the captures of its row of the rule, in order, and
    its result equals the eager call's bit for bit."""
    run, want = CASES[case]
    eager = run(scene, monkeypatch)
    made = _stand_ins(monkeypatch)
    graphed = run(scene, monkeypatch)
    assert made == want
    assert _same(graphed, eager)
