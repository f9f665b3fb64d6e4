"""SpecAugment (time warp, frequency and time masks) on a batch, on the device.

Counterpart of ``asf_tpu/dsp/specaugment.py:34-103``, split in two:

* ``draw`` makes every random integer of a batch with an explicit
  ``torch.Generator`` on the batch's device;
* ``apply`` is batched tensor code over those integers: the warp through
  ``dsp/warp.py:sparse_image_warp``, the masks by index comparison; no
  Python loop over samples.

``torch`` cannot replay ``jax.random``, so the tests feed ``apply`` the
integers the JAX package draws, and check ``draw`` by its distribution.

The semantics kept from the reference (``datasets/spec_augment.py:9-191``):

* the order: time warp, 2 frequency masks, 2 time masks;
* a mask's width ~ U[0, F), start ~ U[0, max(size - width, 1)),
  end ~ U[start, max(start + width, start + 1)): the mask is [start, end);
* each mask is filled with the mean of the spectrogram as it is then, so the
  second fill includes the first mask;
* the early-return quirk: a zero-width draw ends that stage's masks;
* the warp's control point at (F // 2, x) moves by ``dist`` in time, where x
  is the spectrogram's VALUE at the drawn time (the reference's bug,
  ``faithful_warp_bug=True``), or the drawn time itself (the paper's intent).
"""

from __future__ import annotations

import torch

from .warp import sparse_image_warp


def _uniform_below(high: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Integers uniform in [0, high) for a tensor of bounds high >= 1."""
    u = torch.rand(high.shape, generator=generator, device=high.device)
    return torch.minimum((u * high).long(), high - 1)


def _draw_masks(n: int, max_width: int, size: int, batch: int, generator, device):
    width = torch.randint(0, max_width, (batch, n), generator=generator, device=device)
    start = _uniform_below((size - width).clamp(min=1), generator)
    end = start + _uniform_below(width.clamp(min=1), generator)
    return width, start, end


def draw(batch: int, t_len: int, n_mels: int, generator: torch.Generator,
         num_freq_masks=2, num_time_masks=2, freq_mask_param=27, time_mask_param=25,
         warp_param=5) -> dict:
    """The random integers of SpecAugment for ``batch`` (T, F) spectrograms;
    the defaults are the reference's parameters.

    Returns int64 tensors on the generator's device: ``warp_pos`` and
    ``warp_dist`` (B,), drawn from [W, T - W) and [-W, W); ``freq`` and
    ``time``, each a (width, start, end) triple of (B, n_masks) tensors.
    """
    dev = generator.device
    return {
        "warp_pos": torch.randint(warp_param, max(t_len - warp_param, warp_param + 1),
                                  (batch,), generator=generator, device=dev),
        "warp_dist": torch.randint(-warp_param, warp_param, (batch,), generator=generator,
                                   device=dev),
        "freq": _draw_masks(num_freq_masks, freq_mask_param, n_mels, batch, generator, dev),
        "time": _draw_masks(num_time_masks, time_mask_param, t_len, batch, generator, dev),
    }


def time_warp(spec: torch.Tensor, pos: torch.Tensor, dist: torch.Tensor,
              faithful_bug: bool = True) -> torch.Tensor:
    """(B, T, F) -> warped along time. The reference warps each (F, T) image
    with one control point at y = F // 2."""
    bsz, _, n_mels = spec.shape
    img = spec.transpose(1, 2)  # (B, F, T)
    y = n_mels // 2
    if faithful_bug:
        x = img[torch.arange(bsz, device=spec.device), y, pos]  # the value, not the time
    else:
        x = pos.to(spec.dtype)
    src = torch.stack([torch.full_like(x, y), x], dim=1)[:, None, :]  # (B, 1, 2)
    dst = src + torch.stack([torch.zeros_like(x), dist.to(spec.dtype)], dim=1)[:, None, :]
    return sparse_image_warp(img, src, dst).transpose(1, 2)


def _masks(spec: torch.Tensor, width, start, end, axis: int) -> torch.Tensor:
    """Applies the masks of one stage along ``axis`` (1: time, 2: frequency)."""
    idx = torch.arange(spec.shape[axis], device=spec.device)
    shape = [1, 1, 1]
    shape[axis] = -1
    idx = idx.view(shape)
    alive = torch.ones(spec.shape[0], dtype=torch.bool, device=spec.device)
    for i in range(width.shape[1]):
        alive = alive & (width[:, i] > 0)
        s, e = start[:, i].view(-1, 1, 1), end[:, i].view(-1, 1, 1)
        in_mask = (idx >= s) & (idx < e) & alive.view(-1, 1, 1)
        fill = spec.mean(dim=(1, 2)).view(-1, 1, 1)
        spec = torch.where(in_mask, fill, spec)
    return spec


def apply(spec: torch.Tensor, draws: dict, warp_param: int = 5, enable_warp: bool = True,
          faithful_warp_bug: bool = True) -> torch.Tensor:
    """SpecAugment of a (B, T, F) float32 batch with the integers of ``draws``."""
    if enable_warp and spec.shape[1] > 2 * warp_param:
        spec = time_warp(spec, draws["warp_pos"], draws["warp_dist"], faithful_warp_bug)
    spec = _masks(spec, *draws["freq"], axis=2)
    return _masks(spec, *draws["time"], axis=1)


def spec_augment(spec: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Draws and applies SpecAugment with the reference's parameters."""
    return apply(spec, draw(*spec.shape, generator))
