"""Host-side image/target transforms for the data pipeline.

Torch-package copy of easyhec_tpu/data/transforms.py (the reference's
transform set: Compose, Resize, RandomHorizontalFlip, ColorJitter,
ToTensor (here ToFloat), Normalize, ClipRange, CenterCrop, and the
config-driven builder). Pure numpy functions applied on the host before
arrays go to the device, each random one drawing from an explicit
``np.random.Generator``.

Each transform is ``(image, target=None, **aux) -> (image, target, aux)``;
``Compose`` threads them. Images are float32 HWC in [0, 1] (or uint8, which
ToFloat converts); targets are mask arrays [H, W].
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Compose",
    "Resize",
    "RandomHorizontalFlip",
    "ColorJitter",
    "ToFloat",
    "Normalize",
    "ClipRange",
    "CenterCrop",
    "build_transforms",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, image, target=None, **aux):
        for t in self.transforms:
            image, target, aux = t(image, target, **aux)
        return image, target, aux

    def __repr__(self):
        return "Compose(" + ", ".join(repr(t) for t in self.transforms) + ")"


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    y = np.linspace(0, img.shape[0] - 1, h)
    x = np.linspace(0, img.shape[1] - 1, w)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.clip(y0 + 1, 0, img.shape[0] - 1)
    x1 = np.clip(x0 + 1, 0, img.shape[1] - 1)
    fy = (y - y0)[:, None]
    fx = (x - x0)[None, :]
    if img.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (
        a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx
    ).astype(np.float32)


class Resize:
    """Shorter-side / longer-side constrained resize (reference
    transforms.py:42-79 semantics). Bilinear for images, nearest for masks."""

    def __init__(self, min_size: int, max_size: int):
        self.min_size = min_size
        self.max_size = max_size

    def _get_size(self, h: int, w: int) -> tuple[int, int]:
        size = self.min_size
        if self.max_size is not None:
            mn, mx = min(h, w), max(h, w)
            if mx / mn * size > self.max_size:
                size = int(round(self.max_size * mn / mx))
        if (h <= w and h == size) or (w <= h and w == size):
            return h, w
        if h < w:
            return size, int(size * w / h)
        return int(size * h / w), w

    def __call__(self, image, target=None, **aux):
        h, w = self._get_size(image.shape[0], image.shape[1])
        image = _resize_bilinear(np.asarray(image, np.float32), h, w)
        if target is not None:
            target = _resize_nearest(np.asarray(target), h, w)
        return image, target, aux


class RandomHorizontalFlip:
    def __init__(self, prob: float = 0.5, rng: np.random.Generator | None = None):
        self.prob = prob
        self.rng = rng or np.random.default_rng()

    def __call__(self, image, target=None, **aux):
        if self.rng.random() < self.prob:
            image = image[:, ::-1].copy()
            if target is not None:
                target = target[:, ::-1].copy()
        return image, target, aux


class ColorJitter:
    """Brightness/contrast/saturation jitter on [0,1] float RGB
    (capability of reference transforms.py:96-113 without torchvision)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 rng: np.random.Generator | None = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = rng or np.random.default_rng()

    def _factor(self, amount: float) -> float:
        return float(self.rng.uniform(max(0.0, 1 - amount), 1 + amount))

    def __call__(self, image, target=None, **aux):
        img = np.asarray(image, np.float32)
        if self.brightness > 0:
            img = img * self._factor(self.brightness)
        if self.contrast > 0:
            mean = img.mean()
            img = (img - mean) * self._factor(self.contrast) + mean
        if self.saturation > 0 and img.ndim == 3 and img.shape[-1] == 3:
            gray = img.mean(-1, keepdims=True)
            img = (img - gray) * self._factor(self.saturation) + gray
        return np.clip(img, 0.0, 1.0), target, aux


class ToFloat:
    """uint8 [0,255] -> float32 [0,1] (the ToTensor role, minus torch)."""

    def __call__(self, image, target=None, **aux):
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if target is not None:
            target = np.asarray(target, np.float32)
        return np.asarray(img, np.float32), target, aux


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, target=None, **aux):
        return (np.asarray(image, np.float32) - self.mean) / self.std, target, aux


class ClipRange:
    """Clip a depth-like channel into [lo, hi] (reference transforms.py:136-180)."""

    def __init__(self, range):
        self.lo, self.hi = float(range[0]), float(range[1])

    def __call__(self, image, target=None, **aux):
        return np.clip(image, self.lo, self.hi), target, aux


class CenterCrop:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height

    def __call__(self, image, target=None, **aux):
        h, w = image.shape[0], image.shape[1]
        y0 = max((h - self.height) // 2, 0)
        x0 = max((w - self.width) // 2, 0)
        image = image[y0 : y0 + self.height, x0 : x0 + self.width]
        if target is not None:
            target = target[y0 : y0 + self.height, x0 : x0 + self.width]
        # K must shift by the crop offset when intrinsics ride along
        if "K" in aux and aux["K"] is not None:
            K = np.asarray(aux["K"], np.float32).copy()
            K[0, 2] -= x0
            K[1, 2] -= y0
            aux["K"] = K
        return image, target, aux


def build_transforms(specs: list[dict]) -> Compose:
    """Config-driven builder (reference data/transforms/build.py:12-19).

    specs: [{"name": "center_crop", "width": 640, "height": 480}, ...]
    """
    table = {
        "resize": Resize,
        "flip": RandomHorizontalFlip,
        "color_jitter": ColorJitter,
        "to_float": ToFloat,
        "normalize": Normalize,
        "clip_range": ClipRange,
        "center_crop": CenterCrop,
    }
    ts = []
    for spec in specs:
        spec = dict(spec)
        name = spec.pop("name")
        ts.append(table[name](**spec))
    return Compose(ts)
