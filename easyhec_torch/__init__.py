"""easyhec_torch — the PyTorch + CUDA port of easyhec_tpu.

Module names mirror the JAX package (``easyhec_tpu``), which stays the
reference: each module here is held against its counterpart there by the
``tests/test_torch_*.py`` parity tests. This package imports ``torch`` and
numpy only — never ``jax`` or anything of ``easyhec_tpu``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU they raise instead of falling back. Each hand-written CUDA kernel
(``ops/csrc``) has a plain PyTorch version beside it, which its wrapper
takes only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises when CUDA is requested (explicitly or by default) and no GPU is
    present — pass ``device="cpu"`` to run the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "easyhec_torch runs on CUDA by default but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch path"
            )
        # Pose products feed the binning: keep them full f32 (TF32 keeps ~3
        # decimal digits, enough to move a bbox across a tile edge).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
