"""Mel filterbank and window construction (host-side numpy constants).

Copy of ``asf_tpu/dsp/mel.py``. The upstream pipeline computes its log-mel
features with librosa: an HTK mel filterbank with ``norm=None`` and a
periodic Hann window centre-padded to ``n_fft`` (librosa stft defaults).
These are constants of the config, built once in float64 numpy and handed
to the front end as the weights of two products.
"""

from __future__ import annotations

import numpy as np


def hz_to_mel_htk(freq: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz_htk(mel: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """HTK triangular mel filterbank, ``norm=None`` — librosa.filters.mel parity.

    Returns weights of shape (n_mels, 1 + n_fft // 2), float32.
    """
    if fmax is None:
        fmax = float(sr) / 2.0

    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, float(sr) / 2.0, n_freqs, dtype=np.float64)

    min_mel = hz_to_mel_htk(fmin)
    max_mel = hz_to_mel_htk(fmax)
    mel_pts = np.linspace(min_mel, max_mel, n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fftfreqs.reshape(1, -1)

    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))

    return weights.astype(np.float32)


def hann_periodic(win_length: int) -> np.ndarray:
    """Periodic ("fftbins") Hann window — scipy.signal.get_window('hann', N) parity."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float64)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """Hann window centre-padded to n_fft (librosa util.pad_center semantics)."""
    assert n_fft >= win_length
    w = hann_periodic(win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[lpad : lpad + win_length] = w
    return out


def dft_matrices(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT weights.

    Returns ``(W_cos, W_sin)`` each of shape (n_fft, 1 + n_fft//2), float32,
    with the Hann window folded in, such that for a frame ``x`` (length n_fft)

        re = x @ W_cos,  im = -(x @ W_sin)

    matches ``rfft(x * window)``. The magnitude is ``sqrt(re^2 + im^2)``,
    where the sign of ``im`` is irrelevant.
    """
    n_freqs = 1 + n_fft // 2
    window = padded_window(win_length, n_fft)
    n = np.arange(n_fft, dtype=np.float64).reshape(-1, 1)
    k = np.arange(n_freqs, dtype=np.float64).reshape(1, -1)
    angle = 2.0 * np.pi * n * k / n_fft
    w_cos = (np.cos(angle) * window.reshape(-1, 1)).astype(np.float32)
    w_sin = (np.sin(angle) * window.reshape(-1, 1)).astype(np.float32)
    return w_cos, w_sin
