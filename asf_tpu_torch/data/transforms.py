"""Host-side waveform augmentations.

Copy of ``asf_tpu/data/transforms.py`` (numpy and ``scipy.signal``): the
transforms that an annotation row selects by its ``transformation``
column, numpy re-implementations of the audiomentations transforms the
reference uses, with the same distributions:

  * polarity_inversion -- PolarityInversion(p=1.0)
  * gaussian_noise     -- AddGaussianNoise(p=1.0), amplitude U[0.001, 0.015]
  * pitch_shift        -- PitchShift(p=1.0), +-4 semitones, by a phase-vocoder
                          time stretch and a resample back to the length

They draw from the item's own generator and run in the loader's workers.
"""

from __future__ import annotations

import numpy as np


class PolarityInversion:
    def __call__(self, samples: np.ndarray, sample_rate: int, rng=None) -> np.ndarray:
        return -samples


class AddGaussianNoise:
    def __init__(self, min_amplitude: float = 0.001, max_amplitude: float = 0.015):
        self.min_amplitude = min_amplitude
        self.max_amplitude = max_amplitude

    def __call__(self, samples: np.ndarray, sample_rate: int, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        amp = rng.uniform(self.min_amplitude, self.max_amplitude)
        return (samples + amp * rng.standard_normal(len(samples))).astype(samples.dtype)


def _stft(x, n_fft, hop):
    window = np.hanning(n_fft)
    n_frames = 1 + (len(x) - n_fft) // hop if len(x) >= n_fft else 1
    pad_len = (n_frames - 1) * hop + n_fft
    x = np.pad(x, (0, max(0, pad_len - len(x))))
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop][:n_frames]
    return np.fft.rfft(frames * window, axis=1)


def _istft(spec, n_fft, hop, length):
    window = np.hanning(n_fft)
    n_frames = spec.shape[0]
    out = np.zeros((n_frames - 1) * hop + n_fft)
    wsum = np.zeros_like(out)
    frames = np.fft.irfft(spec, n=n_fft, axis=1)
    for t in range(n_frames):
        out[t * hop : t * hop + n_fft] += frames[t] * window
        wsum[t * hop : t * hop + n_fft] += window**2
    out = np.where(wsum > 1e-8, out / np.maximum(wsum, 1e-8), out)
    return out[:length]


def time_stretch(x: np.ndarray, rate: float, n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch (librosa-style)."""
    spec = _stft(x.astype(np.float64), n_fft, hop)
    n_frames = spec.shape[0]
    time_steps = np.arange(0, n_frames, rate)
    phase_adv = np.linspace(0, np.pi * hop, spec.shape[1])
    out = np.zeros((len(time_steps), spec.shape[1]), dtype=complex)
    phase_acc = np.angle(spec[0])
    spec_pad = np.vstack([spec, np.zeros((2, spec.shape[1]), dtype=complex)])
    for i, step in enumerate(time_steps):
        idx = int(step)
        frac = step - idx
        mag = (1 - frac) * np.abs(spec_pad[idx]) + frac * np.abs(spec_pad[idx + 1])
        out[i] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(spec_pad[idx + 1]) - np.angle(spec_pad[idx]) - phase_adv
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc = phase_acc + phase_adv + dphase
    target_len = int(round(len(x) / rate))
    return _istft(out, n_fft, hop, target_len)


class PitchShift:
    """Pitch shift by ±semitones: phase-vocoder stretch then resample back."""

    def __init__(self, min_semitones: float = -4.0, max_semitones: float = 4.0):
        self.min_semitones = min_semitones
        self.max_semitones = max_semitones

    def __call__(self, samples: np.ndarray, sample_rate: int, rng=None) -> np.ndarray:
        from scipy.signal import resample

        rng = rng or np.random.default_rng()
        semitones = rng.uniform(self.min_semitones, self.max_semitones)
        rate = 2.0 ** (semitones / 12.0)
        stretched = time_stretch(samples, rate)
        out = resample(stretched, len(samples))
        return out.astype(samples.dtype if samples.dtype.kind == "f" else np.float32)


def get_transforms():
    """Name -> transform map (parity with src/transforms.py:7-22;
    'time_stretch' is commented out there too)."""
    return {
        "polarity_inversion": PolarityInversion(),
        "gaussian_noise": AddGaussianNoise(),
        "pitch_shift": PitchShift(),
    }
