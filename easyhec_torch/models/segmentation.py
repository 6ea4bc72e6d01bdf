"""Robot mask segmentation: a compact U-Net trained on synthetic renders.

Counterpart of easyhec_tpu/models/segmentation.py (the flax U-Net), as a
``torch.nn.Module``. Synthetic shaded renders and GT masks from the port's
own rasterizer (data/synthetic.py, K4f on the card) train the U-Net, and its
inference plugs in as a MaskSource for the online loop and the annotation
tools. Its convolutions, GroupNorm, pooling and resize are PyTorch's
library operators (cuDNN on the card), as they are XLA's in the JAX package.

The layers match flax's so that weights cross between the packages
(``easyhec_torch.convert``; ``save_params`` writes the flax-layout pickle
that easyhec_tpu's ``load_params`` reads, and ``load_params`` reads either
package's): 3x3 convs with padding 1 (flax "SAME"), GroupNorm with flax's
epsilon 1e-6, 2x2 max pools that floor odd sizes, nearest upsampling as
``jax.image.resize(..., "nearest")`` samples it (torch's "nearest-exact";
torch's "nearest" picks other rows at sizes that are not exact multiples),
and skips concatenated as ``[upsampled, skip]``.

Training follows the JAX loop: per step a batch of ``batch_size`` random
frames, brightness/contrast jitter, binary cross-entropy on the logits and
Adam in optax's order of operations. The draws come from one CPU
``torch.Generator`` seeded by ``seed`` (``draw_training_batches``), not
``jax.random``; the parity tests feed JAX's draws through that function.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..convert import unet_state_from_flax, unet_state_to_flax

__all__ = [
    "UNet",
    "train_segmenter",
    "draw_training_batches",
    "SegmenterMaskSource",
    "save_params",
    "load_params",
]


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        groups = min(8, features)
        self.conv0 = nn.Conv2d(cin, features, 3, padding=1)
        self.gn0 = nn.GroupNorm(groups, features, eps=1e-6)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.gn1 = nn.GroupNorm(groups, features, eps=1e-6)

    def forward(self, x):
        x = F.relu(self.gn0(self.conv0(x)))
        return F.relu(self.gn1(self.conv1(x)))


class UNet(nn.Module):
    """3-level U-Net: 118,913 parameters at base=16. Input [B, H, W, 3]
    float in [0, 1]; output logits [B, H, W]."""

    def __init__(self, base: int = 16):
        super().__init__()
        b = base
        self.base = base
        self.blocks = nn.ModuleList([
            _ConvBlock(3, b), _ConvBlock(b, 2 * b), _ConvBlock(2 * b, 4 * b),
            _ConvBlock(6 * b, 2 * b), _ConvBlock(3 * b, b),
        ])
        self.head = nn.Conv2d(b, 1, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        c1 = self.blocks[0](x)
        c2 = self.blocks[1](F.max_pool2d(c1, 2))
        c3 = self.blocks[2](F.max_pool2d(c2, 2))
        u2 = F.interpolate(c3, size=c2.shape[-2:], mode="nearest-exact")
        m2 = self.blocks[3](torch.cat([u2, c2], dim=1))
        u1 = F.interpolate(m2, size=c1.shape[-2:], mode="nearest-exact")
        m1 = self.blocks[4](torch.cat([u1, c1], dim=1))
        return self.head(m1)[:, 0]


def _flax_init(model: UNet, generator: torch.Generator) -> None:
    """flax's defaults: conv kernels lecun_normal (a normal truncated at two
    standard deviations, scaled to variance 1/fan_in), biases 0, GroupNorm
    scale 1 and bias 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)


def _as_state(params) -> dict[str, torch.Tensor]:
    """A flax parameter tree ({'params': ...}, from either package's
    load_params) or a UNet state dict -> a state dict."""
    return unet_state_from_flax(params) if "params" in params else params


def _bce_loss(logits, targets):
    return torch.mean(
        torch.clamp(logits, min=0) - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def draw_training_batches(seed: int, steps: int, n: int, batch_size: int):
    """Every step's draws at once, from a CPU generator seeded by ``seed``:
    (frame indices [steps, batch_size] int64, brightness scale
    1 + 0.3·N(0, 1) and shift 0.1·N(0, 1), each [steps, batch_size] f32)."""
    g = torch.Generator().manual_seed(int(seed))
    idx = torch.randint(0, n, (steps, batch_size), generator=g)
    scale = 1.0 + 0.3 * torch.randn((steps, batch_size), generator=g)
    shift = 0.1 * torch.randn((steps, batch_size), generator=g)
    return idx, scale, shift


def _adam(params, grads, mu, nu, count: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One optax.adam step over a list of tensors, in optax's order of
    operations (bias corrections in f32 at the incremented count)."""
    mu[:] = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu, b1))
    sq = torch._foreach_mul(grads, grads)
    nu[:] = torch._foreach_add(torch._foreach_mul(sq, 1 - b2), torch._foreach_mul(nu, b2))
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    torch._foreach_add_(params, torch._foreach_mul(u, -lr))


def train_segmenter(
    rgb: np.ndarray,
    masks: np.ndarray,
    steps: int = 500,
    batch_size: int = 4,
    lr: float = 1e-3,
    base: int = 16,
    seed: int = 0,
    augment: bool = True,
    init_params=None,
    device=None,
):
    """Train the U-Net on [N, H, W, 3] uint8 images and [N, H, W] masks on
    ``device`` (None = CUDA). Returns (UNet state dict, final loss).

    init_params: a warm start (a state dict or a flax tree from either
    package's load_params), e.g. to fine-tune at a lower lr; else flax's
    initializers from a generator seeded by ``seed``."""
    dev = resolve_device(device)
    model = UNet(base)
    if init_params is not None:
        model.load_state_dict(_as_state(init_params))
    else:
        _flax_init(model, torch.Generator().manual_seed(int(seed)))
    model.to(dev)
    params = list(model.parameters())
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]

    # torch.tensor copies, so read-only arrays (decoded images) are fine
    imgs = torch.tensor(np.asarray(rgb), device=dev).float() / 255.0
    tgts = torch.tensor(np.asarray(masks), device=dev).float()
    idx, scale, shift = (t.to(dev) for t in draw_training_batches(
        seed, steps, imgs.shape[0], batch_size))
    loss = torch.tensor(float("inf"))  # steps = 0
    for i in range(steps):
        xb, yb = imgs[idx[i]], tgts[idx[i]]
        if augment:
            xb = torch.clamp(xb * scale[i, :, None, None, None]
                             + shift[i, :, None, None, None], 0.0, 1.0)
        loss = _bce_loss(model(xb), yb)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            _adam(params, list(grads), mu, nu, i + 1, lr)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    return state, loss.item()


class SegmenterMaskSource:
    """MaskSource backed by a trained U-Net on ``device`` (None = CUDA);
    ``params`` a state dict or a flax tree (either package's
    load_params)."""

    def __init__(self, params, base: int = 16, threshold: float = 0.5, device=None):
        self.device = resolve_device(device)
        self._model = UNet(base)
        self._model.load_state_dict(_as_state(params))
        self._model.to(self.device).eval()
        self._threshold = threshold

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        return (self.predict_prob(rgb) > self._threshold).astype(np.float32)

    @torch.no_grad()
    def predict_prob(self, rgb: np.ndarray) -> np.ndarray:
        """Raw foreground probability [H, W] in [0, 1]. PromptMasker uses
        this for probability-hysteresis positive points: a click in a
        region the thresholded mask missed admits the connected component
        above a LOWER threshold around the click."""
        x = torch.tensor(np.asarray(rgb), device=self.device).float()
        return torch.sigmoid(self._model(x[None] / 255.0))[0].cpu().numpy()


def save_params(path: str | Path, params) -> None:
    """Pickle ``params`` (a state dict or a flax tree) as the flax tree of
    numpy arrays that both packages' load_params read."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = params if "params" in params else unet_state_to_flax(params)
    with open(path, "wb") as f:
        pickle.dump(tree, f)


def load_params(path: str | Path):
    """The flax parameter tree a save_params of either package wrote (a
    pickle: load only files this program or easyhec_tpu wrote)."""
    with open(path, "rb") as f:
        return pickle.load(f)
