"""Log-mel front end on the device: waveform -> (B, T, n_mels).

Counterpart of ``asf_tpu/dsp/logmel.py:39-194``. The whole chain

    waveform -> framing -> windowed real-DFT -> |.| -> mel product -> log

is one launch of a hand-written kernel (``asf_tpu_torch/ops/logmel.py``),
float32 for ``GPU.DSP_PRECISION="HIGHEST"`` and bf16 inputs with float32
accumulation for ``"BFLOAT16"``; a bf16 front end with a wide window
support runs K3's counterpart, chosen by ``PallasLogMel``'s rule. Then the per-record edge replication of
the upstream loader (np.pad(..., 'edge') to NUM_FRAMES) and the pad or trim
to the output frame count run as plain tensor code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import logmel as ops
from .mel import dft_matrices, mel_filterbank
from .reference import stft_params


def num_frames_for(n_samples: int, hop: int) -> int:
    """librosa frame count for a centred STFT: 1 + n_samples // hop."""
    return 1 + n_samples // hop


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class LogMelParams:
    """Constants of the front end, with the kernels' weights on ``device``."""

    def __init__(self, cfg, device):
        self.sr = cfg.AUDIO_DATA.SAMPLING_RATE
        self.n_fft = cfg.AUDIO_DATA.N_FFT
        self.n_mels = cfg.AUDIO_DATA.NUM_FREQUENCIES
        self.num_frames = cfg.AUDIO_DATA.NUM_FRAMES
        self.win, self.hop = stft_params(cfg)
        # The upstream loader slices [start, start + clip_size - 1): clip_size-1 samples.
        self.clip_size = int(round(self.sr * cfg.AUDIO_DATA.CLIP_SECS))
        self.clip_samples = self.clip_size - 1
        self.n_freqs = 1 + self.n_fft // 2

        w_cos, w_sin = dft_matrices(self.n_fft, self.win)
        mel_w = mel_filterbank(self.sr, self.n_fft, self.n_mels).T  # (n_freqs, n_mels)
        # Nonzero row extent of the window-folded basis: the Hann window is
        # centre-padded into n_fft, so rows outside it are exactly zero and
        # the kernels contract over the support only.
        nz = np.flatnonzero(np.abs(w_cos).sum(axis=1) + np.abs(w_sin).sum(axis=1) > 0.0)
        self.support = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, self.n_fft)
        # The same 128-aligned support as asf_tpu's PallasLogMel, without its
        # n_fft % 128 gate: the kernels here take any n_fft.
        s0, s1 = self.support
        self.s0a = (s0 // 128) * 128
        self.s1a = min(self.n_fft, _round_up(s1, 128))
        self.ksup = self.s1a - self.s0a
        self.off = self.s0a - self.n_fft // 2  # frame t, tap c reads sample t*hop + off + c

        prec = cfg.GPU.DSP_PRECISION.upper()
        if prec not in ("HIGHEST", "BFLOAT16", "BF16", "DEFAULT"):
            raise ValueError(f"unknown GPU.DSP_PRECISION {cfg.GPU.DSP_PRECISION!r}")
        self.fast = prec != "HIGHEST"
        self.dtype = torch.bfloat16 if self.fast else torch.float32
        # K3's rule (asf_tpu/ops/logmel_pallas.py:389-398): a bf16 front end
        # with hop <= 128 whose aligned support is wider than 512 taps and
        # whose support blocks, padded to 128 lanes, cost at most 1.55x the
        # taps; ``kernel`` adds the frame-count limit (:430).
        j_lo, j_hi = s0 // self.hop, (s1 - 1) // self.hop
        self.j_eff = j_hi - j_lo + 1
        self.hopblock = (
            self.fast and self.hop <= 128 and self.ksup > 512
            and (self.j_eff * 128) / self.ksup <= 1.55
        )

        # Nonzero row extent of the mel matrix: a frequency outside it (the
        # DC bin at the flagship geometry) feeds no mel bin, so its DFT column
        # is dropped as exactly as the zero basis rows are. Basis column j is
        # frequency freqs[0] + j.
        nzf = np.flatnonzero(np.abs(mel_w).sum(axis=1) > 0.0)
        self.freqs = (int(nzf[0]), int(nzf[-1]) + 1) if nzf.size else (0, self.n_freqs)
        f0, f1 = self.freqs
        kf = _round_up(f1 - f0, ops.FREQ_CHUNK)
        m = _round_up(self.n_mels, ops.MEL_WIDTH)
        wc = np.zeros((self.ksup, kf), np.float32)
        ws = np.zeros((self.ksup, kf), np.float32)
        wc[:, : f1 - f0] = w_cos[self.s0a : self.s1a, f0:f1]
        ws[:, : f1 - f0] = w_sin[self.s0a : self.s1a, f0:f1]
        melp = np.zeros((kf, m), np.float32)
        melp[: f1 - f0, : self.n_mels] = mel_w[f0:f1]
        # float64 -> float32 -> compute dtype: the same two roundings as asf_tpu.
        self.w_cos = torch.from_numpy(wc).to(device=device, dtype=self.dtype)
        self.w_sin = torch.from_numpy(ws).to(device=device, dtype=self.dtype)
        self.mel_w = torch.from_numpy(melp).to(device=device, dtype=self.dtype)

    def kernel(self, n_frames: int):
        """The kernel wrapper for ``n_frames`` frames: K1's, K2's or K3's counterpart."""
        if not self.fast:
            return ops.logmel_f32
        if self.hopblock and _round_up(n_frames, 8) <= 512:
            return ops.logmel_bf16_wide
        return ops.logmel_bf16

    def geometry(self, n_samples: int) -> dict:
        """Keyword arguments of the kernels for a waveform of ``n_samples``."""
        return dict(
            hop=self.hop, off=self.off, n_frames=num_frames_for(n_samples, self.hop),
            n_mels=self.n_mels,
        )


def log_mel_frames(wave: torch.Tensor, params: LogMelParams, eps: float = 1e-6) -> torch.Tensor:
    """(B, S) float waveform -> (B, 1 + S//hop, n_mels) float32, one kernel launch.

    The waveform is rounded to the kernel's type before framing, as
    asf_tpu does (framing only copies samples, so the frames are the same).
    """
    kernel = params.kernel(num_frames_for(wave.shape[1], params.hop))
    return kernel(
        wave.to(params.dtype).contiguous(), params.w_cos, params.w_sin, params.mel_w,
        eps=eps, **params.geometry(wave.shape[1]),
    )


def edge_pad(log_mel: torch.Tensor, n_valid_samples: Optional[torch.Tensor], hop: int,
             t_out: int) -> torch.Tensor:
    """Pad or trim to ``t_out`` frames and edge-replicate past each record's end.

    Frames at and past ``1 + n_valid // hop`` repeat the last valid frame,
    the upstream np.pad(..., 'edge') to NUM_FRAMES (``asf_tpu/dsp/logmel.py:174-194``).
    """
    b, n_frames, _ = log_mel.shape
    if n_valid_samples is not None:
        valid = 1 + n_valid_samples.to(device=log_mel.device, dtype=torch.long) // hop
        limit = torch.clamp(valid, max=n_frames)
    else:
        limit = torch.full((b,), n_frames, dtype=torch.long, device=log_mel.device)
    if n_frames < t_out:
        log_mel = torch.nn.functional.pad(log_mel, (0, 0, 0, t_out - n_frames))
    else:
        log_mel = log_mel[:, :t_out]
    idx = (limit - 1).clamp(0, t_out - 1)
    edge = log_mel.gather(1, idx[:, None, None].expand(b, 1, log_mel.shape[2]))
    keep = torch.arange(t_out, device=log_mel.device)[None, :, None] < limit[:, None, None]
    return torch.where(keep, log_mel, edge)


def log_mel_spectrogram(
    wave: torch.Tensor,
    params: LogMelParams,
    n_valid_samples: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
    out_frames: Optional[int] = None,
) -> torch.Tensor:
    """Batched waveform -> log-mel spectrogram.

    Args:
      wave: (B, S) waveform (fixed S; short records zero-padded).
      params: precomputed constants and weights.
      n_valid_samples: optional (B,) true record length per sample; frames
        past ``1 + n_valid // hop`` are edge-replicated.
      out_frames: output frame count (defaults to max(NUM_FRAMES, n_frames)).

    Returns:
      (B, T_out, n_mels) float32.
    """
    wave = wave.float()
    n_frames = num_frames_for(wave.shape[1], params.hop)
    log_mel = log_mel_frames(wave, params, eps)
    t_out = out_frames if out_frames is not None else max(params.num_frames, n_frames)
    return edge_pad(log_mel, n_valid_samples, params.hop, t_out)
