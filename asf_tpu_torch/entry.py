"""Entry point of the port: the flagship eval forward, waveform -> probabilities.

Counterpart of ``__graft_entry__.py:17-65``: the VGG-Sound ``AudioSlowFast``
(SlowFast-R50, 309 classes, bf16 trunk) behind the log-mel front end,
in eval mode (softmax, then the mean over positions).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import get_cfg
from .engine.pipeline import make_input_pipeline
from .models import build_model
from .utils.torch_setup import disable_tf32, resolve_device


def flagship_cfg():
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "AudioSlowFast"
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = [309]  # VGG-Sound
    cfg.RESNET.DEPTH = 50
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3, 3], [4, 4], [6, 6], [3, 3]]
    cfg.RESNET.FREQUENCY_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.FREQUENCY_DILATIONS = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.GPU.COMPUTE_DTYPE = "bfloat16"
    return cfg


def clip_samples(cfg) -> int:
    """Samples in one clip: the upstream loader slices clip_size - 1."""
    return int(round(cfg.AUDIO_DATA.SAMPLING_RATE * cfg.AUDIO_DATA.CLIP_SECS)) - 1


def entry(batch: int = 8, dsp_precision: str = "HIGHEST", device=None, cfg=None):
    """Returns ``(fn, (model, wave, n_valid))`` with ``fn(model, wave, n_valid) -> probs``.

    ``model`` is the ``AudioSlowFast`` of ``cfg`` (default: ``flagship_cfg()``)
    in eval mode, with weights drawn from ``torch.Generator().manual_seed(0)``
    (other weights: ``model.load_state_dict``);
    ``wave`` is a (batch, clip_samples) float32 example and ``n_valid`` its
    (batch,) record lengths. ``fn`` also takes int16 waveforms; its input
    pipeline is ``fn.pipeline``. Runs on the
    current CUDA device unless ``device="cpu"``; raises when CUDA is absent
    and no device was given.
    """
    device = resolve_device(device)
    disable_tf32()
    cfg = (cfg if cfg is not None else flagship_cfg()).clone()
    cfg.GPU.DSP_PRECISION = dsp_precision
    model = build_model(cfg, device, torch.Generator().manual_seed(0)).eval()
    pipeline = make_input_pipeline(cfg, device)

    s = clip_samples(cfg)
    wave = np.random.default_rng(0).standard_normal((batch, s)).astype(np.float32) * 0.1
    wave = torch.from_numpy(wave).to(device)
    n_valid = torch.full((batch,), s, dtype=torch.int32, device=device)

    @torch.inference_mode()
    def fn(model, wave, n_valid):
        return model(pipeline(wave, n_valid))

    fn.pipeline = pipeline
    return fn, (model, wave, n_valid)
