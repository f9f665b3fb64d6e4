"""The input pipeline on the device: waveforms -> pathway tensors.

Counterpart of ``asf_tpu/engine/steps.py:80-128``: int16 samples are scaled
by 1/32768, the log-mel front end runs with ``out_frames = NUM_FRAMES``, in
training SpecAugment runs on the edge-padded float32 spectrogram
(``GPU.SPEC_AUGMENT``), and the slow pathway gathers ``slow_indices`` frames
(a single-pathway Slow-only or Fast-only model takes every frame).
Outputs are NCHW ``(B, 1, T, F)``, PyTorch's layout; the JAX package's are
NHWC ``(B, T, F, 1)``. A batch of window chains, waveform ``(B, N, S)`` and
``n_valid`` ``(B, N)``, is flattened to ``B * N`` rows: one front-end launch
for all of them, SpecAugment drawn row by row, and pathways of ``(B, N, 1,
T, F)`` for the GRU model, which flattens them again for its trunk.

The pipeline runs under ``torch.no_grad()``: no gradient flows into the
waveform in the JAX package, and the log-mel kernels have no backward. It
is the span ``step.frontend`` (``utils/spans.py``). The slow pathway's
index is kept on the device, one tensor per (frames, alpha, device), copied
there on its first use and never again: a copy from the host's pageable
memory would wait for the card on every step.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..dsp.logmel import LogMelParams, log_mel_spectrogram
from ..dsp.pathways import slow_indices
from ..dsp.specaugment import spec_augment
from ..parallel import dist
from ..utils.spans import span


@functools.lru_cache(maxsize=64)
def slow_index(frames: int, alpha: int, device: torch.device) -> torch.Tensor:
    """The slow pathway's frame indices (``dsp/pathways.py:slow_indices``) on ``device``."""
    return torch.from_numpy(slow_indices(frames, alpha)).to(device)


def pack_pathways(cfg, spec: torch.Tensor) -> list[torch.Tensor]:
    """(B, T, F) spectrogram -> the pathways as (B, 1, T', F): [spec] for a
    single-pathway arch (``MODEL.SINGLE_PATHWAY_ARCH``: every frame, no
    subsampling), [slow, fast] for SlowFast; another arch raises, as
    ``asf_tpu/dsp/pathways.py:65-68`` does."""
    arch = cfg.MODEL.ARCH
    if arch in cfg.MODEL.SINGLE_PATHWAY_ARCH:
        return [spec.unsqueeze(1)]
    if arch not in cfg.MODEL.MULTI_PATHWAY_ARCH:
        raise NotImplementedError(
            f"Model arch {arch} is not in "
            f"{list(cfg.MODEL.SINGLE_PATHWAY_ARCH) + list(cfg.MODEL.MULTI_PATHWAY_ARCH)}")
    idx = slow_index(spec.shape[1], int(cfg.SLOWFAST.ALPHA), spec.device)
    return [x.unsqueeze(1) for x in (spec.index_select(1, idx), spec)]


class InputPipeline:
    """``pipeline(waveform, n_valid[, generator, train]) -> list of (B, 1, T, F)``.

    With ``train=True`` and ``GPU.SPEC_AUGMENT``, SpecAugment draws from
    ``generator`` (a ``torch.Generator`` on the waveform's device), for the
    global batch of the process group it was built in, and applies this
    data rank's rows of the draws (the ranks of a model group apply the
    same rows).
    """

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.params = LogMelParams(cfg, device)
        self.augment = bool(cfg.GPU.SPEC_AUGMENT)
        self.share = (dist.data_rank(cfg), dist.data_size(cfg))

    @torch.no_grad()
    def __call__(self, waveform: torch.Tensor, n_valid: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 train: bool = False) -> list[torch.Tensor]:
        with span("step.frontend"):
            chains = waveform.shape[:-1] if waveform.dim() == 3 else None
            if chains is not None:
                waveform = waveform.reshape(-1, waveform.shape[-1])
                n_valid = n_valid.reshape(-1)
            if waveform.dtype == torch.int16:
                # 16-bit PCM shipped as raw samples; the same scale as the host
                # conversion of the upstream wav loader.
                waveform = waveform.float() / 32768.0
            spec = log_mel_spectrogram(
                waveform, self.params, n_valid_samples=n_valid,
                out_frames=self.cfg.AUDIO_DATA.NUM_FRAMES,
            )
            if train and self.augment:
                if generator is None:
                    raise ValueError("SpecAugment needs a generator in training")
                spec = spec_augment(spec, generator, self.share)
            paths = pack_pathways(self.cfg, spec)
            if chains is not None:
                paths = [x.reshape(*chains, *x.shape[1:]) for x in paths]
            return paths


def make_input_pipeline(cfg, device) -> InputPipeline:
    return InputPipeline(cfg, device)
