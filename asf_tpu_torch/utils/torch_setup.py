"""Process-level PyTorch setup: device resolution and float32 precision.

Counterpart of ``asf_tpu/utils/jax_setup.py``. The port never falls back
to the CPU on its own: with no CUDA device an entry point raises unless
its caller asked for ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def disable_tf32() -> None:
    """Keep float32 matmuls and convolutions in full float32.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits and breaks parity with the JAX package's
    ``Precision.HIGHEST`` (``asf_tpu/models/layers.py:47``,
    ``asf_tpu/dsp/logmel.py:73-76``). bf16 paths are not affected.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
