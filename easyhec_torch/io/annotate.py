"""Prompt-based mask annotation — interactive and programmatic.

Counterpart of easyhec_tpu/io/annotate.py (the reference's SAM annotation
stack: box/point prompts, pos/neg labels, undo/reset, mask union and
subtraction). Prompting is model-pluggable:

- `PromptMasker`: programmatic box/point prompting. The default backend is
  classical (OpenCV's GrabCut seeded by the prompts; ``cv2`` is imported at
  its first call, so on a machine without OpenCV that backend raises
  ImportError); a `MaskSource`-style model (e.g. the U-Net's
  models/segmentation.SegmenterMaskSource) can be passed to gate its
  prediction by the same prompts instead.
- `PromptDrawer`: the interactive OpenCV window (box drag, left/right click
  = pos/neg point, u undo, r reset, space/enter accept). Needs OpenCV and a
  display; everything else is headless.

Connected components are scipy.ndimage's 4-connected labels. One fix over
the reference: a negative box whose far corner lies left of or above the
image (x1 < 0 or y1 < 0) removes nothing, where the reference's slice
``[max(y0, 0):y1 + 1]`` wraps to a negative end and zeroes almost the
whole mask.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "PromptMasker",
    "PromptDrawer",
    "Prompts",
    "AnnotationSession",
    "annotate_repl",
]


@dataclass
class Prompts:
    boxes: list[tuple[int, int, int, int]] = field(default_factory=list)  # x0,y0,x1,y1
    points: list[tuple[int, int]] = field(default_factory=list)
    labels: list[int] = field(default_factory=list)  # 1 pos / 0 neg
    # subtract-regions (the reference PromptDrawer's mask-subtraction
    # mode, prompt_drawer.py): carved out of the final mask LAST — the
    # robust tool against confidently-wrong attached false positives,
    # where point semantics (component removal / confidence bounds) fail
    neg_boxes: list[tuple[int, int, int, int]] = field(default_factory=list)

    def add_box(self, x0, y0, x1, y1, label: int = 1):
        box = (min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1))
        (self.boxes if label else self.neg_boxes).append(box)

    def add_point(self, x, y, label=1):
        self.points.append((int(x), int(y)))
        self.labels.append(int(label))

    def undo(self):
        if self.points:
            self.points.pop()
            self.labels.pop()
        elif self.neg_boxes:
            self.neg_boxes.pop()
        elif self.boxes:
            self.boxes.pop()

    def reset(self):
        self.boxes.clear()
        self.points.clear()
        self.labels.clear()
        self.neg_boxes.clear()


class PromptMasker:
    """Turn prompts into a mask.

    backend=None: GrabCut seeded from boxes/points (no checkpoints needed).
    backend=MaskSource-like (has .predict(rgb)): the model's mask is
    restricted to the prompted boxes and grown/cut by the point labels.
    """

    def __init__(self, backend=None, grabcut_iters: int = 5,
                 hysteresis: float = 0.2, neg_hysteresis: float = 0.75):
        self.backend = backend
        self.grabcut_iters = grabcut_iters
        # lower probability threshold admitted by a positive click in a
        # region the thresholded model mask missed (see _model_mask)
        self.hysteresis = hysteresis
        # upper bound for the low-confidence sub-region a negative click
        # removes when the FP is attached to the true mask (see
        # _model_mask); clicks on pixels above it delete the component
        self.neg_hysteresis = neg_hysteresis

    def predict(self, rgb: np.ndarray, prompts: Prompts) -> np.ndarray:
        if self.backend is not None:
            return self._model_mask(rgb, prompts)
        return self._grabcut_mask(rgb, prompts)

    # -- classical backend ----------------------------------------------------
    def _grabcut_mask(self, rgb: np.ndarray, prompts: Prompts) -> np.ndarray:
        import cv2

        H, W = rgb.shape[:2]
        out = np.zeros((H, W), np.float32)
        boxes = prompts.boxes or ([(0, 0, W - 1, H - 1)] if prompts.points else [])
        for box in boxes:
            x0, y0, x1, y1 = box
            x1 = min(x1, W - 1)
            y1 = min(y1, H - 1)
            if x1 - x0 < 2 or y1 - y0 < 2:
                continue
            gmask = np.full((H, W), cv2.GC_BGD, np.uint8)
            gmask[y0 : y1 + 1, x0 : x1 + 1] = cv2.GC_PR_FGD
            for (px, py), lab in zip(prompts.points, prompts.labels):
                if 0 <= py < H and 0 <= px < W:
                    cv2.circle(gmask, (px, py), 3,
                               int(cv2.GC_FGD if lab else cv2.GC_BGD), -1)
            bgd = np.zeros((1, 65), np.float64)
            fgd = np.zeros((1, 65), np.float64)
            try:
                cv2.grabCut(rgb[..., :3].astype(np.uint8), gmask, None, bgd, fgd,
                            self.grabcut_iters, cv2.GC_INIT_WITH_MASK)
                m = ((gmask == cv2.GC_FGD) | (gmask == cv2.GC_PR_FGD)).astype(np.float32)
            except cv2.error:  # degenerate color models
                m = np.zeros((H, W), np.float32)
                m[y0 : y1 + 1, x0 : x1 + 1] = 1.0
            out = np.maximum(out, m)
        # negative points always punch holes (mask subtraction, reference
        # prompt_drawer.py mask-subtract mode)
        out = self._apply_negative_points(out, prompts)
        return self._apply_neg_boxes(out, prompts)

    def _model_mask(self, rgb: np.ndarray, prompts: Prompts) -> np.ndarray:
        mask = np.asarray(self.backend.predict(rgb), np.float32)
        H, W = mask.shape
        if prompts.boxes:
            keep = np.zeros((H, W), bool)
            for x0, y0, x1, y1 in prompts.boxes:
                keep[y0 : y1 + 1, x0 : x1 + 1] = True
            mask = mask * keep
        else:
            keep = np.ones((H, W), bool)
        # Positive points grow the mask two ways:
        # 1. the point lands on a predicted component the box cut away ->
        #    restore that component;
        # 2. the point lands where the THRESHOLDED mask missed but the
        #    model still assigns some probability (backend.predict_prob)
        #    -> admit the connected component above a LOWER threshold
        #    around the click (probability hysteresis — SAM-like click
        #    semantics for near-miss regions, e.g. dark parts whose
        #    probability sits between the hysteresis and the threshold).
        full = np.asarray(self.backend.predict(rgb), np.float32) > 0.5
        comp_full = _connected_components(full)
        prob = None
        comp_low = None
        if hasattr(self.backend, "predict_prob"):
            prob = np.asarray(self.backend.predict_prob(rgb), np.float32)
            comp_low = _connected_components(prob > self.hysteresis)
        for (px, py), lab in zip(prompts.points, prompts.labels):
            if not (0 <= py < H and 0 <= px < W) or lab != 1:
                continue
            if full[py, px] and mask[py, px] < 0.5:
                mask = np.maximum(
                    mask, (comp_full == comp_full[py, px]).astype(np.float32)
                )
            elif (
                not full[py, px]
                and comp_low is not None
                and prob[py, px] > self.hysteresis
            ):
                grown = (comp_low == comp_low[py, px]) & keep
                mask = np.maximum(mask, grown.astype(np.float32))
        # Negative clicks, hysteresis-bounded when probabilities exist:
        # deleting the whole connected component (the classical-backend
        # semantics below) nukes the entire annotation when a false-
        # positive region is ATTACHED to the true mask — one blob. With
        # predict_prob, a negative click instead removes the connected
        # LOW-CONFIDENCE sub-region (mask & prob < neg_hysteresis) under
        # the point; a click on a >= neg_hysteresis pixel still removes
        # the full component (the user insists — isolated confident FPs).
        if prob is not None:
            neg = [(p, l) for p, l in
                   zip(prompts.points, prompts.labels) if l == 0]
            if neg:
                comp = None
                comp_weak = None
                for (px, py), _ in neg:
                    if not (0 <= py < H and 0 <= px < W) or mask[py, px] <= 0.5:
                        continue
                    if prob[py, px] < self.neg_hysteresis:
                        if comp_weak is None:
                            comp_weak = _connected_components(
                                (mask > 0.5) & (prob < self.neg_hysteresis)
                            )
                        mask = mask * (comp_weak != comp_weak[py, px])
                    else:
                        if comp is None:
                            comp = _connected_components(mask > 0.5)
                        mask = mask * (comp != comp[py, px])
            return self._apply_neg_boxes(mask, prompts)
        mask = self._apply_negative_points(mask, prompts)
        return self._apply_neg_boxes(mask, prompts)

    @staticmethod
    def _apply_neg_boxes(mask: np.ndarray, prompts: Prompts) -> np.ndarray:
        if prompts.neg_boxes:
            mask = mask.copy()
            for x0, y0, x1, y1 in prompts.neg_boxes:
                # both slice ends clamped at 0: a box wholly off the top or
                # left edge is an empty slice, not a wrapped one
                mask[max(y0, 0) : max(y1 + 1, 0), max(x0, 0) : max(x1 + 1, 0)] = 0.0
        return mask

    @staticmethod
    def _apply_negative_points(mask: np.ndarray, prompts: Prompts) -> np.ndarray:
        neg = [(p, l) for p, l in zip(prompts.points, prompts.labels) if l == 0]
        if not neg:
            return mask
        comp = _connected_components(mask > 0.5)
        for (px, py), _ in neg:
            if 0 <= py < mask.shape[0] and 0 <= px < mask.shape[1] and mask[py, px] > 0.5:
                mask = mask * (comp != comp[py, px])
        return mask


def _connected_components(binary: np.ndarray) -> np.ndarray:
    """4-connected labels (0 = background, components 1..n)."""
    from scipy import ndimage

    return ndimage.label(binary)[0]


class AnnotationSession:
    """Incremental annotation state machine (the click → re-segment →
    inspect → accept workflow of the reference PromptDrawer,
    easyhec/utils/prompt_drawer.py:59-133, decoupled from any UI).

    Every prompt mutation re-runs the backend; `undo` removes the most
    recent prompt and re-segments. Drive it from the cv2 window
    (PromptDrawer), the terminal REPL (annotate_repl), or tests."""

    def __init__(self, rgb: np.ndarray, masker: PromptMasker | None = None):
        self.rgb = np.asarray(rgb)
        self.masker = masker or PromptMasker()
        self.prompts = Prompts()
        self.mask = np.zeros(self.rgb.shape[:2], np.float32)

    def _refresh(self) -> np.ndarray:
        if self.prompts.boxes or self.prompts.points:
            self.mask = self.masker.predict(self.rgb, self.prompts)
        else:
            self.mask = np.zeros(self.rgb.shape[:2], np.float32)
        return self.mask

    def add_box(self, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
        self.prompts.add_box(x0, y0, x1, y1)
        return self._refresh()

    def add_point(self, x: int, y: int, label: int = 1) -> np.ndarray:
        self.prompts.add_point(x, y, label)
        return self._refresh()

    def undo(self) -> np.ndarray:
        self.prompts.undo()
        return self._refresh()

    def reset(self) -> np.ndarray:
        self.prompts.reset()
        return self._refresh()

    def stats(self) -> dict:
        m = self.mask > 0.5
        ys, xs = np.nonzero(m)
        return {
            "area_px": int(m.sum()),
            "area_frac": float(m.mean()),
            "n_components": int(_connected_components(m).max()),
            "bbox": (
                [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]
                if m.any() else None
            ),
            "n_prompts": len(self.prompts.boxes) + len(self.prompts.points),
        }

    def overlay(self) -> np.ndarray:
        from ..utils.imaging import vis_mask

        return vis_mask(self.rgb, self.mask, color=(0, 255, 0), alpha=0.45)

    def ascii_preview(self, width: int = 64) -> str:
        """Coarse terminal rendering of the current mask over the image."""
        H, W = self.mask.shape
        w = min(width, W)
        h = max(1, round(H * w / W / 2))  # terminal cells are ~2:1
        sy, sx = H // h or 1, W // w or 1
        m = self.mask[: h * sy, : w * sx].reshape(h, sy, w, sx).mean((1, 3))
        g = self.rgb[: h * sy, : w * sx, :3].mean(-1)
        g = g.reshape(h, sy, w, sx).mean((1, 3)) / 255.0
        rows = []
        for i in range(h):
            row = []
            for j in range(w):
                if m[i, j] > 0.5:
                    row.append("#")
                elif m[i, j] > 0.1:
                    row.append("+")
                else:
                    row.append(" .:-="[min(4, int(g[i, j] * 5))])
            rows.append("".join(row))
        return "\n".join(rows)


_REPL_HELP = """commands:
  box X0 Y0 X1 Y1   add a box prompt (re-segments)
  pos X Y           add a positive point
  neg X Y           add a negative point (punches the component)
  undo              remove the last prompt and re-segment
  reset             clear all prompts
  show              print stats + ASCII preview (and save overlay.png)
  accept            finish, return the mask
  skip              finish, return None
  help              this text"""


def annotate_repl(
    rgb: np.ndarray,
    masker: PromptMasker | None = None,
    input_fn=input,
    echo=print,
    overlay_path: str | None = None,
) -> np.ndarray | None:
    """Terminal-driven incremental annotation (headless counterpart of the
    reference's interactive SAM window). Reads commands from `input_fn`
    (stdin by default; pass an iterator's __next__ for scripted use),
    re-segments after every prompt change, and prints compact feedback.
    Returns the accepted mask or None on skip."""
    s = AnnotationSession(rgb, masker)
    echo(f"annotating {rgb.shape[1]}x{rgb.shape[0]} image; 'help' for commands")
    while True:
        try:
            line = input_fn("annotate> " if input_fn is input else "")
        except (EOFError, StopIteration):
            return None
        cmd, *args = (line.strip().split() or [""])
        try:
            if cmd == "box" and len(args) == 4:
                s.add_box(*map(int, args))
            elif cmd in ("pos", "neg") and len(args) == 2:
                s.add_point(int(args[0]), int(args[1]), 1 if cmd == "pos" else 0)
            elif cmd == "undo":
                s.undo()
            elif cmd == "reset":
                s.reset()
            elif cmd == "show":
                echo(s.ascii_preview())
                if overlay_path is not None:
                    from ..utils.imaging import save_image

                    save_image(overlay_path, s.overlay())
                    echo(f"overlay saved to {overlay_path}")
            elif cmd == "accept":
                return s.mask
            elif cmd == "skip":
                return None
            elif cmd in ("help", "?"):
                echo(_REPL_HELP)
                continue
            elif cmd == "":
                continue
            else:
                echo(f"unknown command {line!r}; 'help' for commands")
                continue
        except ValueError as e:
            echo(f"bad arguments: {e}")
            continue
        st = s.stats()
        echo(
            f"mask: {st['area_px']} px ({100*st['area_frac']:.1f}%), "
            f"{st['n_components']} component(s), "
            f"{st['n_prompts']} prompt(s)"
        )


class PromptDrawer:  # pragma: no cover - needs a display
    """Interactive annotation window (the reference PromptDrawer UI role).

    Controls: drag = box prompt; left click = positive point; right click =
    negative point; u = undo; r = reset; space/enter = accept; q/esc = skip.
    """

    def __init__(self, masker: PromptMasker | None = None, window: str = "annotate"):
        self.masker = masker or PromptMasker()
        self.window = window

    def run(self, rgb: np.ndarray) -> np.ndarray | None:
        import cv2

        prompts = Prompts()
        mask = np.zeros(rgb.shape[:2], np.float32)
        drag = {"active": False, "x0": 0, "y0": 0}

        def redraw():
            from ..utils.imaging import vis_mask

            disp = vis_mask(rgb, mask, color=(0, 255, 0), alpha=0.45)
            cv2.imshow(self.window, cv2.cvtColor(disp, cv2.COLOR_RGB2BGR))

        def on_mouse(event, x, y, flags, _):
            nonlocal mask
            if event == cv2.EVENT_LBUTTONDOWN:
                drag.update(active=True, x0=x, y0=y)
            elif event == cv2.EVENT_LBUTTONUP and drag["active"]:
                drag["active"] = False
                if abs(x - drag["x0"]) > 4 and abs(y - drag["y0"]) > 4:
                    prompts.add_box(drag["x0"], drag["y0"], x, y)
                else:
                    prompts.add_point(x, y, 1)
                mask = self.masker.predict(rgb, prompts)
                redraw()
            elif event == cv2.EVENT_RBUTTONDOWN:
                prompts.add_point(x, y, 0)
                mask = self.masker.predict(rgb, prompts)
                redraw()

        cv2.namedWindow(self.window)
        cv2.setMouseCallback(self.window, on_mouse)
        redraw()
        while True:
            k = cv2.waitKey(50) & 0xFF
            if k in (ord(" "), 13):
                cv2.destroyWindow(self.window)
                return mask
            if k in (ord("q"), 27):
                cv2.destroyWindow(self.window)
                return None
            if k == ord("u"):
                prompts.undo()
                mask = self.masker.predict(rgb, prompts)
                redraw()
            if k == ord("r"):
                prompts.reset()
                mask[:] = 0
                redraw()
