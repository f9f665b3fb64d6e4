"""The plain front end: waveform -> log-mel -> SpecAugment -> the two pathways.

Float32 throughout (the caller turns TF32 off). The log-mel is librosa's
``stft(n_fft, hann window of win samples centre-padded, hop, center=True,
pad_mode="constant")``, ``|.|``, an HTK mel filterbank with ``norm=None``
and ``log(mel + 1e-6)``, written as two ``torch.matmul`` products over the
frames; the upstream loader's hop quirk (``hop = win - hop`` when the window
is the longer) is kept. Frames at and past ``1 + n_valid // hop`` repeat the
last valid frame (the upstream ``np.pad(..., "edge")``), and the spectrogram
is cut or padded to ``NUM_FRAMES``.

SpecAugment follows ``datasets/spec_augment.py`` of the upstream repository:
a time warp (one control point at the middle mel bin, moved by ``dist``
frames; its time coordinate is the spectrogram's value at the drawn frame,
the upstream code's own slip, kept), 2 frequency masks of up to 27 bins and
2 time masks of up to 25 frames, each filled with the spectrogram's mean as
it is then, a zero-width mask ending its stage. Its random integers are drawn
from a ``torch.Generator`` in a fixed order (warp position, warp distance,
then width, start and end of the frequency masks and of the time masks), so
that a generator seeded alike draws the same integers as any program that
draws in that order.

The slow pathway takes ``torch.linspace(0, T - 1, T // alpha).long()``
frames on the CPU, the upstream ``pack_pathway_output``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def stft_geometry(m: dict) -> tuple[int, int]:
    """(win, hop) in samples, with the upstream hop quirk."""
    sr = m["sampling_rate"]
    win = int(round(m["window_ms"] * sr / 1e3))
    hop = int(round(m["hop_ms"] * sr / 1e3))
    if win - hop > 0:
        hop = win - hop
    return win, hop


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """HTK triangular filters, ``norm=None``: (n_mels, 1 + n_fft // 2) float64."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)

    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper))


def hann_window(win: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window of ``win`` samples, centre-padded to ``n_fft``."""
    n = np.arange(win, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    out = np.zeros(n_fft)
    lpad = (n_fft - win) // 2
    out[lpad:lpad + win] = w
    return out


class LogMel:
    """The log-mel of a model's numbers ``m`` on ``device``, float32."""

    def __init__(self, m: dict, device):
        self.n_fft = m["n_fft"]
        self.win, self.hop = stft_geometry(m)
        self.num_frames = m["num_frames"]
        window = hann_window(self.win, self.n_fft)
        k = np.arange(1 + self.n_fft // 2)
        angle = 2.0 * np.pi * np.arange(self.n_fft)[:, None] * k[None, :] / self.n_fft
        self.w_cos = torch.tensor(np.cos(angle) * window[:, None], dtype=torch.float32,
                                  device=device)
        self.w_sin = torch.tensor(np.sin(angle) * window[:, None], dtype=torch.float32,
                                  device=device)
        self.mel = torch.tensor(mel_filterbank(m["sampling_rate"], self.n_fft,
                                               m["n_mels"]).T, dtype=torch.float32,
                                device=device)

    def __call__(self, wave: torch.Tensor, n_valid: torch.Tensor, quant=None) -> torch.Tensor:
        """(B, S) float32 waveform, (B,) valid samples -> (B, NUM_FRAMES, n_mels).
        ``quant`` (the lower-precision control) rounds the products' inputs."""
        pad = self.n_fft // 2
        frames = F.pad(wave, (pad, pad)).unfold(1, self.n_fft, self.hop)  # (B, T, n_fft)
        w_cos, w_sin, mel = self.w_cos, self.w_sin, self.mel
        if quant is not None:
            frames, w_cos, w_sin = quant(frames), quant(w_cos), quant(w_sin)
        mag = torch.sqrt(torch.matmul(frames, w_cos) ** 2 + torch.matmul(frames, w_sin) ** 2)
        if quant is not None:
            mag, mel = quant(mag), quant(mel)
        spec = torch.log(torch.matmul(mag, mel) + 1e-6)
        b, t, _ = spec.shape
        limit = torch.clamp(1 + n_valid.long() // self.hop, max=t)
        t_out = self.num_frames
        spec = F.pad(spec, (0, 0, 0, t_out - t)) if t < t_out else spec[:, :t_out]
        idx = (limit - 1).clamp(0, t_out - 1)
        edge = spec.gather(1, idx[:, None, None].expand(b, 1, spec.shape[2]))
        keep = torch.arange(t_out, device=spec.device)[None, :, None] < limit[:, None, None]
        return torch.where(keep, spec, edge)


# -- SpecAugment -------------------------------------------------------------

WARP, FREQ_MASK, TIME_MASK, N_MASKS = 5, 27, 25, 2


def _below(high: torch.Tensor, generator) -> torch.Tensor:
    u = torch.rand(high.shape, generator=generator, device=high.device)
    return torch.minimum((u * high).long(), high - 1)


def _mask_draws(max_width: int, size: int, batch: int, generator, device):
    width = torch.randint(0, max_width, (batch, N_MASKS), generator=generator, device=device)
    start = _below((size - width).clamp(min=1), generator)
    end = start + _below(width.clamp(min=1), generator)
    return width, start, end


def spec_augment_draws(batch: int, t_len: int, n_mels: int, generator) -> dict:
    dev = generator.device
    return {
        "warp_pos": torch.randint(WARP, max(t_len - WARP, WARP + 1), (batch,),
                                  generator=generator, device=dev),
        "warp_dist": torch.randint(-WARP, WARP, (batch,), generator=generator, device=dev),
        "freq": _mask_draws(FREQ_MASK, n_mels, batch, generator, dev),
        "time": _mask_draws(TIME_MASK, t_len, batch, generator, dev),
    }


def _phi(r2):
    return 0.5 * r2 * torch.log(r2.clamp(min=1e-10))


def _sq_dists(x, y):
    return ((x ** 2).sum(-1, keepdim=True) - 2.0 * (x @ y.transpose(1, 2))
            + (y ** 2).sum(-1, keepdim=True).transpose(1, 2))


def _warp(img: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, reg: float = 1e-6):
    """``tf.contrib.image.sparse_image_warp`` with one control point, a
    thin-plate spline and bilinear sampling; img (B, H, W), points (B, 1, 2)."""
    b, h, w = img.shape
    gy, gx = torch.meshgrid(torch.arange(h, dtype=img.dtype, device=img.device),
                            torch.arange(w, dtype=img.dtype, device=img.device), indexing="ij")
    q = torch.stack([gy.reshape(-1), gx.reshape(-1)], 1).expand(b, h * w, 2)
    values = dst - src
    a = _phi(_sq_dists(dst, dst))
    b1 = torch.cat([dst[:, 0], dst.new_ones(b, 1)], 1)
    wgt = values / (a[:, 0, 0] + reg - (b1 ** 2).sum(1) / reg)[:, None, None]
    v = (-wgt / reg) * b1[:, :, None]
    flow = _phi(_sq_dists(q, dst)) @ wgt + torch.cat([q, torch.ones_like(q[..., :1])], 2) @ v
    p = q - flow
    fy = torch.floor(p[..., 0]).clamp(0.0, h - 2.0)
    fx = torch.floor(p[..., 1]).clamp(0.0, w - 2.0)
    ay = (p[..., 0] - fy).clamp(0.0, 1.0)
    ax = (p[..., 1] - fx).clamp(0.0, 1.0)
    flat = img.reshape(b, h * w)
    i = fy.long() * w + fx.long()
    tl, tr = flat.gather(1, i), flat.gather(1, i + 1)
    bl, br = flat.gather(1, i + w), flat.gather(1, i + w + 1)
    top, bot = tl + ax * (tr - tl), bl + ax * (br - bl)
    return (top + ay * (bot - top)).reshape(b, h, w)


def _apply_masks(spec, width, start, end, axis: int):
    idx = torch.arange(spec.shape[axis], device=spec.device).view([-1 if a == axis else 1
                                                                   for a in range(3)])
    alive = torch.ones(spec.shape[0], dtype=torch.bool, device=spec.device)
    for i in range(width.shape[1]):
        alive = alive & (width[:, i] > 0)
        s, e = start[:, i].view(-1, 1, 1), end[:, i].view(-1, 1, 1)
        inside = (idx >= s) & (idx < e) & alive.view(-1, 1, 1)
        spec = torch.where(inside, spec.mean(dim=(1, 2)).view(-1, 1, 1), spec)
    return spec


def spec_augment(spec: torch.Tensor, generator) -> torch.Tensor:
    """(B, T, F) float32 -> augmented, drawing from ``generator``."""
    b, t_len, n_mels = spec.shape
    d = spec_augment_draws(b, t_len, n_mels, generator)
    if t_len > 2 * WARP:
        img = spec.transpose(1, 2)  # (B, F, T)
        y = n_mels // 2
        x = img[torch.arange(b, device=spec.device), y, d["warp_pos"]]
        src = torch.stack([torch.full_like(x, y), x], 1)[:, None, :]
        dst = src + torch.stack([torch.zeros_like(x), d["warp_dist"].to(x.dtype)], 1)[:, None]
        spec = _warp(img, src, dst).transpose(1, 2)
    spec = _apply_masks(spec, *d["freq"], axis=2)
    return _apply_masks(spec, *d["time"], axis=1)


def pathways(spec: torch.Tensor, alpha: int) -> list[torch.Tensor]:
    """(B, T, F) -> [slow (B, 1, T // alpha, F), fast (B, 1, T, F)]."""
    t = spec.shape[1]
    idx = torch.linspace(0, t - 1, t // alpha).long()
    return [spec.index_select(1, idx.to(spec.device)).unsqueeze(1), spec.unsqueeze(1)]


def num_windows(duration_s: float, clip_s: float, overlap_s: float, cap: int) -> int:
    """A chain's windows: ceil((d - overlap) / (clip - overlap)), at least 1, capped."""
    return min(int(math.ceil(max((duration_s - overlap_s) / (clip_s - overlap_s), 1))), cap)


def bucket(n: int, cap: int) -> int:
    """``n`` windows rounded up to a power of two, capped."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)
