"""Offline mask annotation CLI.

Counterpart of easyhec_tpu/cli/annotate.py: label every color/*.png (and
*.jpg) of a capture dir into mask/. Modes:

- --auto --weights W: run the trained U-Net segmenter
  (models/segmentation.py, weights from either package's save_params) over
  every frame; with --box/--point as well, the segmenter is the prompt
  backend.
- --box x0 y0 x1 y1 [--point x y l ...]: programmatic prompts applied to
  every frame (headless; without --auto the GrabCut backend, which needs
  OpenCV).
- --repl: terminal-driven interactive session per frame
  (io/annotate.annotate_repl); works over ssh with no display.
- default: the interactive OpenCV window per frame (needs a display).

    python -m easyhec_torch.cli.annotate --data-dir DIR --auto --weights seg.pkl \\
        [--box X0 Y0 X1 Y1] [--point X Y L] [--overwrite] [--device cuda|cpu]

PNG frames are read and masks written with the standard-library PNG codec
(utils.imaging.read_png / write_png); a mask is always written as PNG,
named after its frame's stem. The segmenter runs on CUDA unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="annotate masks for a capture dir")
    ap.add_argument("--data-dir", required=True, help="dir with color/*.png")
    ap.add_argument("--auto", action="store_true", help="use the U-Net segmenter")
    ap.add_argument("--weights", default=None, help="segmenter params (.pkl)")
    ap.add_argument("--box", type=int, nargs=4, action="append", default=None)
    ap.add_argument("--point", type=int, nargs=3, action="append", default=None,
                    help="x y label (1 pos / 0 neg)")
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--repl", action="store_true",
                    help="terminal-driven interactive annotation (headless)")
    ap.add_argument("--device", default="cuda", help="torch device of the segmenter")
    args = ap.parse_args(argv)

    from ..data.dataset import _imread
    from ..io.annotate import PromptDrawer, PromptMasker, Prompts, annotate_repl
    from ..utils.imaging import write_png

    data = Path(args.data_dir)
    color_dir = data / "color"
    mask_dir = data / "mask"
    mask_dir.mkdir(parents=True, exist_ok=True)
    frames = sorted(color_dir.glob("*.png")) + sorted(color_dir.glob("*.jpg"))
    if not frames:
        raise SystemExit(f"no frames under {color_dir}")

    backend = None
    if args.auto:
        if not args.weights:
            raise SystemExit("--auto needs --weights (train via cli.train_segmenter)")
        from ..models.segmentation import SegmenterMaskSource, load_params

        backend = SegmenterMaskSource(load_params(args.weights), device=args.device)

    prompts = Prompts()
    for b in args.box or []:
        prompts.add_box(*b)
    for p in args.point or []:
        prompts.add_point(p[0], p[1], p[2])
    headless = args.auto or prompts.boxes or prompts.points
    masker = PromptMasker(backend=backend)

    n_done = 0
    for f in frames:
        out = mask_dir / f"{f.stem}.png"
        if out.exists() and not args.overwrite:
            continue
        rgb = _imread(f)
        if rgb.ndim == 2:
            rgb = np.repeat(rgb[..., None], 3, axis=-1)
        if args.repl:  # pragma: no cover - interactive terminal
            print(f"--- frame {f.name} ---")
            mask = annotate_repl(rgb, masker,
                                 overlay_path=str(mask_dir / f"{f.stem}_overlay.png"))
            if mask is None:
                continue
        elif headless:
            if args.auto and not (prompts.boxes or prompts.points):
                mask = backend.predict(rgb)
            else:
                mask = masker.predict(rgb, prompts)
        else:  # pragma: no cover - interactive
            mask = PromptDrawer(masker).run(rgb)
            if mask is None:
                continue
        write_png(out, (np.asarray(mask) > 0.5).astype(np.uint8) * 255)
        n_done += 1
    print(f"wrote {n_done} masks to {mask_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
