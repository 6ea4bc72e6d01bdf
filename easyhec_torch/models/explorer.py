"""Consistency-based space exploration — next joint-pose selection.

Torch counterpart of easyhec_tpu/models/explorer.py:

    variance[c] = Σ_pixels Var_h( silhouette(candidate c, hypothesis h) )

Candidates are scored in batches of ``score_batch`` frames on the
renderer's device, hypothesis after hypothesis, with the self-collision and
workspace gates as batched sphere tests; only the chosen candidates go to
the host-side motion planner (easyhec_torch.io.planner).

Where the JAX package compiles the whole scoring pass into one program
(``lax.map`` over candidate batches, ``lax.scan`` over hypotheses), this
captures one candidate batch as a CUDA graph, once per ``_score`` call, and
replays it for every batch: all hypotheses' bin states and renders (one bin
state and one render per hypothesis on the exact path, one bin state per
batch on the shared path) and the variance sums, reading the batch through
a device index. On the CPU the same batch function runs eagerly, and so do
the stateless routes (the top-k binner, brute, use_pallas=False) on any
device. The overflow flags are OR-ed on the device and read once per
``_score`` call. The random draws come from a ``torch.Generator`` on the
CPU (``draw_hypotheses_and_candidates``), so the card and the CPU draw the
same numbers; they are not JAX's.

Spans (utils.profiling): ``explore.call`` around ``explore`` (counts
``bin_states``, ``escalations``, ``shared``), ``explore.draw`` (the draws and
the hypotheses' spread), ``explore.score.queue`` (``_score``: the gates, the
capture and the batches' replays), ``explore.score.read`` (the overflow
flag's host read), ``explore.escalate`` (a renderer with doubled budgets) and
``explore.finish``. When a torch profiler records the capture, the batch's
graph also times each ``explore.bin_state`` and ``explore.render`` on the
device (utils.profiling.DeviceSpans), read after the overflow read: their
sums over the call's batches.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..geometry import se3
from ..render.fused import CompactState, silhouette_compact
from ..render.renderer import RobotRenderer
from ..robot import KinematicChain
from ..robot.mesh import TriMesh
from ..utils import cuda_graph
from ..utils.profiling import DeviceSpans, span

__all__ = [
    "LinkSpheres",
    "build_link_spheres",
    "SpaceExplorer",
    "ExploreResult",
    "draw_hypotheses_and_candidates",
]


@dataclass(frozen=True)
class LinkSpheres:
    """Sphere approximation of the robot's links for fast collision tests.

    centers: [L, S, 3] in link frame; radii: [L, S] (0-radius = unused slot);
    pair_mask: [L, L] bool — True where a pair must be CHECKED (non-adjacent,
    non-self; the reference gets this from the SRDF's allowed-collision list).
    """

    centers: np.ndarray
    radii: np.ndarray
    pair_mask: np.ndarray
    link_indices: np.ndarray  # chain link index per row


def build_link_spheres(
    chain: KinematicChain,
    link_meshes: dict[str, TriMesh],
    spheres_per_link: int = 4,
    adjacent_skip: int = 1,
) -> LinkSpheres:
    """Fit a few bounding spheres per link by slicing the mesh along its
    longest axis. Crude but conservative — right shape for a feasibility
    gate."""
    names = [n for n in link_meshes]
    L, S = len(names), spheres_per_link
    centers = np.zeros((L, S, 3), np.float32)
    radii = np.zeros((L, S), np.float32)
    for i, n in enumerate(names):
        v = link_meshes[n].vertices
        lo, hi = v.min(0), v.max(0)
        axis = int(np.argmax(hi - lo))
        order = np.argsort(v[:, axis])
        chunks = np.array_split(order, S)
        for s, idx in enumerate(chunks):
            if len(idx) == 0:
                continue
            pts = v[idx]
            c = (pts.min(0) + pts.max(0)) / 2
            centers[i, s] = c
            radii[i, s] = float(np.linalg.norm(pts - c, axis=1).max())
    link_indices = np.asarray([chain.link_index(n) for n in names], np.int32)
    # Check only pairs more than `adjacent_skip` apart in the serial chain —
    # neighbours legitimately touch (SRDF-allowed collisions in the reference).
    pair = np.zeros((L, L), bool)
    for i in range(L):
        for j in range(L):
            pair[i, j] = (j - i) > adjacent_skip
    return LinkSpheres(centers, radii, pair, link_indices)


@dataclass
class ExploreResult:
    qpos: np.ndarray  # chosen next joint configuration
    variance: float
    var_all: np.ndarray  # [C] variance per candidate (-inf = infeasible)
    feasible: np.ndarray  # [C] bool
    qpos_all: np.ndarray  # [C, n_dof]


def draw_hypotheses_and_candidates(key: int, n_hypotheses: int, n_hist: int,
                                   n_sample: int, lo: np.ndarray, hi: np.ndarray):
    """The explorer's two random draws, from one CPU ``torch.Generator``
    seeded with ``key``: hypothesis indices into the history [n_hypotheses]
    (int64) and candidate qposes uniform in [lo, hi) [n_sample, n_dof]
    (float32). -> (sel, qposes) as numpy."""
    g = torch.Generator(device="cpu").manual_seed(int(key))
    sel = torch.randint(0, n_hist, (n_hypotheses,), generator=g)
    lo_t = torch.as_tensor(lo, dtype=torch.float32)
    hi_t = torch.as_tensor(hi, dtype=torch.float32)
    u = torch.rand((n_sample, lo_t.shape[0]), generator=g)
    return sel.numpy(), (lo_t + u * (hi_t - lo_t)).numpy()


class SpaceExplorer:
    def __init__(
        self,
        chain: KinematicChain,
        renderer: RobotRenderer,
        link_names: list[str],
        spheres: LinkSpheres | None = None,
        n_sample_qposes: int = 1000,
        n_hypotheses: int = 10,
        history_start: int = 200,
        max_dist: float | None = 0.5,
        limit_fraction: float = 0.9,
        collision_margin: float = 0.0,
        score_batch: int = 5,  # candidates per bin+render call
    ):
        self.chain = chain
        self.renderer = renderer
        self.link_idx = np.asarray([chain.link_index(n) for n in link_names])
        self.spheres = spheres
        self.n_sample_qposes = n_sample_qposes
        self.n_hypotheses = n_hypotheses
        self.history_start = history_start
        self.max_dist = max_dist
        self.limit_fraction = limit_fraction
        self.collision_margin = collision_margin
        self.score_batch = score_batch

    # -- feasibility gates (vectorized over candidates) --------------------

    def _self_collision_free(self, link_poses: torch.Tensor) -> torch.Tensor:
        """link_poses: [C, n_links, 4, 4] -> [C] bool."""
        dev = link_poses.device
        if self.spheres is None:
            return torch.ones(link_poses.shape[0], dtype=torch.bool, device=dev)
        sp = self.spheres
        poses = link_poses[:, torch.as_tensor(sp.link_indices, device=dev).long()]
        R = poses[..., :3, :3]
        t = poses[..., :3, 3]
        centers = torch.as_tensor(sp.centers, device=dev)
        c = torch.einsum("clij,lsj->clsi", R, centers) + t[:, :, None, :]
        r = torch.as_tensor(sp.radii, device=dev)  # [L, S]
        # Pairwise: [C, L, S, L', S']
        d = torch.linalg.norm(c[:, :, :, None, None, :] - c[:, None, None, :, :, :], dim=-1)
        rsum = r[:, :, None, None] + r[None, None, :, :]
        # Only count spheres that exist (radius > 0) and checked pairs
        exists = (r > 0)[:, :, None, None] & (r > 0)[None, None, :, :]
        pair = torch.as_tensor(sp.pair_mask, device=dev)[:, None, :, None]
        viol = (d - rsum < self.collision_margin) & exists & pair
        return ~viol.flatten(1).any(dim=1)

    def _within_workspace(self, link_poses: torch.Tensor) -> torch.Tensor:
        if self.max_dist is None:
            return torch.ones(link_poses.shape[0], dtype=torch.bool, device=link_poses.device)
        origins = link_poses[..., :3, 3]  # [C, n_links, 3]
        base = origins[:, :1]
        return torch.all(torch.linalg.norm(origins - base, dim=-1) <= self.max_dist, dim=-1)

    # -- scoring -----------------------------------------------------------

    def _can_share_bins(self) -> bool:
        """Shared-bin scoring needs a reusable bin-state path: the count
        binner (BinState → counted silhouette) or the fused states
        (CompactState → render.fused.silhouette_compact, FusedState → the
        dense silhouette)."""
        return self.renderer.kernel_route and self.renderer.tile.binner == "count"

    def hypothesis_spread_px(self, hyp_dofs: np.ndarray, K: np.ndarray) -> float:
        """Max pixel displacement of robot-workspace probe points across the
        hypothesis poses, from their projection at the mean pose (host-side).
        Decides whether one tile binning per candidate can serve every
        hypothesis (the rebin-reuse contract: bboxes drift less than the
        binning margin)."""
        probes = self._probe_points()
        Kn = np.asarray(K, np.float64)

        def project(dof):
            T = se3.exp(torch.as_tensor(np.asarray(dof), dtype=torch.float32))
            T = T.numpy().astype(np.float64)
            pc = probes @ T[:3, :3].T + T[:3, 3]
            z = np.maximum(pc[:, 2], 0.05)
            return np.stack(
                [Kn[0, 0] * pc[:, 0] / z + Kn[0, 2],
                 Kn[1, 1] * pc[:, 1] / z + Kn[1, 2]], axis=-1)

        dofs = np.asarray(hyp_dofs, np.float64)
        pix_mean = project(dofs.mean(axis=0))
        pix = np.stack([project(d) for d in dofs])  # [Hh, P, 2]
        return float(np.abs(pix - pix_mean[None]).max())

    def _probe_points(self) -> np.ndarray:
        """Base-frame probe cloud for hypothesis_spread_px: link origins and
        each renderer link's mesh AABB corners under FK at several workspace
        configurations (zero, the scaled joint limits, mid). A richer cloud
        raises the measured spread, which only pushes wide cases to the
        exact per-pair path — the safe direction."""
        if not hasattr(self, "_probes"):
            lim = np.asarray(self.chain.joint_limits, np.float64)
            lo = np.where(np.isfinite(lim[:, 0]), lim[:, 0], -np.pi)
            hi = np.where(np.isfinite(lim[:, 1]), lim[:, 1], np.pi)
            f = self.limit_fraction
            qs = [np.zeros(self.chain.n_dof), f * lo, f * hi, (lo + hi) / 2]
            corners = np.asarray(self.renderer.link_aabb_corners(), np.float64)  # [L, 8, 3]
            pts = []
            for q in qs:
                lp = self.chain.fk_np(np.asarray(q, np.float32))
                pts.append(np.asarray(lp[:, :3, 3], np.float64))
                sel = np.asarray(lp[self.link_idx], np.float64)  # [L, 4, 4]
                c = (np.einsum("lij,lcj->lci", sel[:, :3, :3], corners)
                     + sel[:, None, :3, 3])
                pts.append(c.reshape(-1, 3))
            self._probes = np.concatenate(pts, axis=0)
        return self._probes

    def _escalate_budgets(self) -> None:
        """Double the capacity-class bin budgets (capacity, bin_big_k, the
        compact chunk budgets when in use) and grow the rect enumeration
        window, then rebuild the renderer on the same device and in the same
        mode. The overflow flag covers both bin saturation and rect-window
        misses: candidate qposes can swing links close to the camera, where
        triangle spans exceed any capacity-only escalation. ``_score`` keeps
        no state across calls (its CUDA graph, captured at the old shapes,
        is dropped when the call returns, as the JAX package clears its
        jitted programs here), so nothing of the old renderer survives."""
        r = self.renderer
        t = r.tile
        n_ty = -(-r.H // t.tile_h)
        n_tx = -(-r.W // t.tile_w)
        t2 = t._replace(
            capacity=t.capacity * 2,
            bin_big_k=t.bin_big_k * 2 if t.bin_big_k else t.bin_big_k,
            compact_chunks=t.compact_chunks * 2 if t.compact_chunks else 0,
            bwd_chunks=t.bwd_chunks * 2 if t.bwd_chunks else 0,
            rect_y=min(t.rect_y * 2, n_ty) if t.rect_y else t.rect_y,
            rect_x=min(t.rect_x * 2, n_tx) if t.rect_x else t.rect_x,
        )
        self.renderer = RobotRenderer(r.meshes, r.H, r.W, tile=t2, mode=r.mode,
                                      device=r.device)

    @torch.no_grad()
    def _score(self, qposes, hyp_dofs, K, shared: bool = False):
        """Variance score per candidate and feasibility, on the renderer's
        device: -> (var [C] with -inf where infeasible, feasible [C] bool,
        overflow [] bool), all tensors on that device."""
        r = self.renderer
        dev = r.device
        f32 = torch.float32
        qposes = torch.tensor(np.asarray(qposes), dtype=f32, device=dev)
        hyp_dofs = torch.tensor(np.asarray(hyp_dofs), dtype=f32, device=dev)
        K = torch.tensor(np.asarray(K), dtype=f32, device=dev)
        all_poses = self.chain.fk(qposes)  # [C, n_links, 4, 4]
        feasible = self._self_collision_free(all_poses) & self._within_workspace(all_poses)
        lp = all_poses[:, torch.as_tensor(self.link_idx, device=dev).long()]  # [C, L, 4, 4]
        Ts = se3.exp(hyp_dofs)  # [Hh, 4, 4]
        C, Hh = lp.shape[0], Ts.shape[0]
        # Candidates go in batches of `score_batch` frames per bin + render
        # call; the last batch is padded with candidate 0.
        cb = max(1, min(self.score_batch, C))
        pad = (-C) % cb
        if pad:
            lp = torch.cat([lp, lp[:1].expand((pad,) + lp.shape[1:])])
        batches = lp.reshape((-1, cb) + lp.shape[1:])
        nb = batches.shape[0]

        t = r.tile
        compact_renderer = t.fused and t.compact_chunks > 0
        # A count-binner renderer exposes an explicit bin state, the only
        # way the per-render overflow flag is observable.
        counted = r.kernel_route and t.binner == "count"
        # introspection: bin states built, and the largest tile load among
        # them (read by explore after the overflow flag, no extra sync)
        self.last_bin_states = 0
        self._max_load = torch.zeros((), dtype=torch.int64, device=dev)
        self._device_spans = spans = DeviceSpans(("explore.bin_state", "explore.render"), dev)
        if not (shared or compact_renderer or counted):
            # Stateless routes: one batched render of every hypothesis per
            # batch, eagerly (their overflow flag is not observable).
            L = lp.shape[1]
            var = []
            for lp_b in batches:
                lp_full = lp_b[:, None].expand(cb, Hh, L, 4, 4).reshape(cb * Hh, L, 4, 4)
                Ts_full = Ts[None].expand(cb, Hh, 4, 4).reshape(cb * Hh, 4, 4)
                sils = r.silhouette(Ts_full, lp_full, K)
                sils = sils.reshape((cb, Hh) + sils.shape[-2:])
                var.append(torch.sum(torch.var(sils, dim=1, unbiased=False), dim=(-2, -1)))
            var = torch.cat(var)[:C]
            overflow = torch.zeros((), dtype=torch.bool, device=dev)
            return torch.where(feasible, var, torch.full_like(var, -torch.inf)), feasible, overflow

        # State-driven scoring, hypothesis after hypothesis:
        # - shared: bin once per batch at the MEAN hypothesis pose and render
        #   every hypothesis against the same bins (the caller gates on
        #   hypothesis_spread_px <= margin - 2);
        # - exact: bin at each hypothesis pose.
        # One batch is one function of static tensors (the batches, a device
        # batch index, the scores and flags it writes); on CUDA it is captured
        # as one graph and replayed for every batch (the JAX package maps one
        # compiled program over the batches).
        T_mean = se3.exp(hyp_dofs.mean(dim=0))
        bufs = dict(
            bidx=torch.zeros(1, dtype=torch.int64, device=dev),
            var=torch.zeros((nb, cb), dtype=f32, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            max_load=self._max_load,
        )

        def batch(b):
            def bin_state(T):
                with spans.span("explore.bin_state"):
                    st = r.bin_state(T, lp_b, K)
                self.last_bin_states += 1
                torch.maximum(b["max_load"], st.counts.max().long(), out=b["max_load"])
                return st

            def render(T_h, state):
                with spans.span("explore.render"):
                    if isinstance(state, CompactState):
                        sil = silhouette_compact(r, T_h, K, state)
                    else:
                        sil = r.silhouette(T_h, lp_b, K, bin_state=state)
                return sil, torch.any(state.overflow)

            lp_b = batches.index_select(0, b["bidx"])[0]
            st0 = bin_state(T_mean) if shared else None

            def state_at(T_h):
                return st0 if shared else bin_state(T_h)

            # Variance from the deviations from hypothesis 0's silhouette:
            # E[d²] − E[d]² with d_0 = 0. The uncentered E[x²] − E[x]²
            # cancels two O(1) sums and leaves ~3e-5 of float noise on
            # identical hypotheses.
            sil0, ov = render(Ts[0], state_at(Ts[0]))
            s = torch.zeros_like(sil0)
            s2 = torch.zeros_like(sil0)
            for h in range(1, Hh):
                sil, ov_h = render(Ts[h], state_at(Ts[h]))
                d = sil - sil0
                s, s2, ov = s + d, s2 + d * d, ov | ov_h
            v = torch.sum(s2 / Hh - (s / Hh) ** 2, dim=(-2, -1))
            b["var"].index_copy_(0, b["bidx"], v[None])
            b["overflow"] |= ov
            b["bidx"] += 1

        cuda_graph.repeat(batch, bufs, nb, cuda_graph.captures(dev), (self, "last_bin_states"))
        var = bufs["var"].reshape(-1)[:C]
        var = torch.where(feasible, var, torch.full_like(var, -torch.inf))
        return var, feasible, bufs["overflow"]

    def explore(
        self,
        history: np.ndarray,
        K: np.ndarray,
        key: int = 0,
        qpos_candidates: np.ndarray | None = None,
    ) -> ExploreResult:
        """Pick the next qpos maximizing render disagreement across the pose
        history (reference forward(), space_explorer.py:49-197)."""
        with span("explore.call") as counts:
            result = self._explore(history, K, key, qpos_candidates)
            counts.update(bin_states=self.last_bin_states, escalations=self.last_escalations,
                          shared=int(self.last_shared))
        return result

    def _explore(self, history, K, key, qpos_candidates) -> ExploreResult:
        with span("explore.draw"):
            hist = np.asarray(history)
            hist = hist[min(self.history_start, max(len(hist) - 1, 0)):]
            if len(hist) == 0:
                raise ValueError("empty pose history")
            f = self.limit_fraction
            lim = np.asarray(self.chain.joint_limits, np.float32)
            sel, qposes = draw_hypotheses_and_candidates(
                key, self.n_hypotheses, len(hist), self.n_sample_qposes,
                lim[:, 0] * np.float32(f), lim[:, 1] * np.float32(f),
            )
            hyp_dofs = np.asarray(hist, np.float32)[np.asarray(sel)]
            if qpos_candidates is not None:
                qposes = np.asarray(qpos_candidates, np.float32)

            # Shared-bin fast path when every hypothesis stays within the
            # binning margin of their mean (minus soft-band slack); wide
            # clouds take the exact per-pair path.
            shared = False
            spread = float("nan")
            if self._can_share_bins():
                spread = self.hypothesis_spread_px(hyp_dofs, K)
                shared = spread <= float(self.renderer.tile.margin) - 2.0
        # introspection for benchmarks/logs
        self.last_shared = shared
        self.last_spread_px = spread
        self.last_escalations = 0

        def score():
            with span("explore.score.queue"):
                var, feasible, overflow = self._score(qposes, hyp_dofs, K, shared=shared)
            with span("explore.score.read"):
                overflow = bool(overflow)
                self._device_spans.read()
            return var, feasible, overflow

        var, feasible, overflow = score()
        # Truncated bins rank variance on wrong silhouettes: escalate the
        # budgets 2x and re-score, as the trainers do on BinOverflowError.
        log = logging.getLogger("easyhec_torch")
        while overflow and self.last_escalations < 3:
            self.last_escalations += 1
            log.warning("explorer: tile-bin overflow during candidate scoring — "
                        "escalating budgets 2x and re-scoring (attempt %d)",
                        self.last_escalations)
            with span("explore.escalate"):
                self._escalate_budgets()
            var, feasible, overflow = score()
        if overflow:
            log.warning("explorer: tile-bin overflow persists after escalation — "
                        "variance ranking may be degraded; decimate more")
        with span("explore.finish"):
            self.last_max_load = int(self._max_load)
            var_np = var.cpu().numpy()
            if not np.isfinite(var_np).any():
                raise RuntimeError("no feasible qpos among candidates")
            best = int(np.argmax(var_np))
            return ExploreResult(
                qpos=np.asarray(qposes[best]),
                variance=float(var_np[best]),
                var_all=var_np,
                feasible=feasible.cpu().numpy(),
                qpos_all=np.asarray(qposes),
            )
