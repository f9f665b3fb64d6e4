"""Host-side numpy reference of the exact librosa log-mel pipeline.

Copy of ``asf_tpu/dsp/reference.py``. librosa is not a dependency; this
module re-expresses the semantics the upstream loader invokes:

    stft(audio, n_fft=2048, window="hann", hop_length=hop, win_length=win,
         pad_mode="constant")            # center=True default
    mel = filters.mel(sr, n_fft, n_mels, htk=True, norm=None) @ |stft|
    log_mel = log(mel + 1e-6).T          # -> (frames, n_mels)

including the upstream hop-length quirk: when ``win > hop`` in samples,
the effective hop becomes ``win - hop`` (at the 10 ms / 5 ms defaults both
are 5 ms). It is the golden reference of the port's front-end tests.
"""

from __future__ import annotations

import numpy as np

from .mel import mel_filterbank, padded_window


def stft_params(cfg) -> tuple[int, int]:
    """(win_length, effective hop_length) in samples, with the upstream quirk."""
    sr = cfg.AUDIO_DATA.SAMPLING_RATE
    win = int(round(cfg.AUDIO_DATA.WINDOW_LENGTH * sr / 1e3))
    hop = int(round(cfg.AUDIO_DATA.HOP_LENGTH * sr / 1e3))
    if win - hop > 0:
        hop = win - hop
    return win, hop


def stft_magnitude_np(
    audio: np.ndarray, n_fft: int, win_length: int, hop_length: int
) -> np.ndarray:
    """|STFT| with librosa semantics (center=True, pad_mode='constant').

    Returns (1 + n_fft//2, n_frames) float64.
    """
    audio = np.asarray(audio, dtype=np.float64)
    pad = n_fft // 2
    padded = np.pad(audio, (pad, pad), mode="constant")
    n_frames = 1 + (len(padded) - n_fft) // hop_length
    window = padded_window(win_length, n_fft)
    frames = np.lib.stride_tricks.as_strided(
        padded,
        shape=(n_frames, n_fft),
        strides=(padded.strides[0] * hop_length, padded.strides[0]),
    )
    spec = np.fft.rfft(frames * window, axis=1)
    return np.abs(spec).T


def log_mel_np(cfg, audio: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """Full reference DSP chain: audio -> (n_frames, n_mels) log-mel, float32.

    Does NOT pad/trim to NUM_FRAMES — that is the caller's job.
    """
    win, hop = stft_params(cfg)
    mag = stft_magnitude_np(audio, cfg.AUDIO_DATA.N_FFT, win, hop)
    mel_W = mel_filterbank(
        cfg.AUDIO_DATA.SAMPLING_RATE, cfg.AUDIO_DATA.N_FFT, cfg.AUDIO_DATA.NUM_FREQUENCIES
    ).astype(np.float64)
    mel = mel_W @ mag
    return np.log(mel + eps).T.astype(np.float32)


def pad_to_num_frames(spec: np.ndarray, num_frames: int) -> np.ndarray:
    """Edge-pad the time axis up to ``num_frames``."""
    pad = num_frames - spec.shape[0]
    if pad > 0:
        spec = np.pad(spec, ((0, pad), (0, 0)), mode="edge")
    return spec
