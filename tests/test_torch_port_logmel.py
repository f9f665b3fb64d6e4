"""Log-mel front end of the PyTorch port against the JAX package.

The same seeded numpy waveforms go through ``asf_tpu`` (its Pallas kernels
in interpret mode on the CPU: K1 ``_partial_mel`` for HIGHEST, K2
``_resident_logmel`` for BFLOAT16) and through ``asf_tpu_torch``, whose
wrappers take their kernels' plain PyTorch versions for CPU tensors. The
CUDA kernels themselves are held against those plain versions on the card
(``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.dsp import reference as jax_ref
from asf_tpu.dsp.logmel import LogMelParams as JaxLogMelParams
from asf_tpu.dsp.logmel import log_mel_spectrogram as jax_log_mel
from asf_tpu.dsp.pathways import slow_indices as jax_slow_indices
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.dsp import reference as port_ref
from asf_tpu_torch.dsp.logmel import LogMelParams, log_mel_spectrogram
from asf_tpu_torch.dsp.pathways import slow_indices
from asf_tpu_torch.entry import flagship_cfg
from asf_tpu_torch.ops import logmel as ops


def _small(cfg):
    """The small geometry of tests/test_pallas_logmel.py:19-28."""
    cfg.AUDIO_DATA.SAMPLING_RATE = 4000
    cfg.AUDIO_DATA.N_FFT = 256
    cfg.AUDIO_DATA.CLIP_SECS = 0.5
    cfg.AUDIO_DATA.NUM_FRAMES = 120
    cfg.AUDIO_DATA.NUM_FREQUENCIES = 40
    return cfg


def _pair(precision):
    jcfg = _small(jax_get_cfg())
    jcfg.TPU.USE_PALLAS_DSP = True
    jcfg.TPU.DSP_PRECISION = precision
    pcfg = _small(get_cfg())
    pcfg.GPU.DSP_PRECISION = precision
    jp = JaxLogMelParams(jcfg)
    assert jp.pallas is not None
    return jcfg, jp, pcfg, LogMelParams(pcfg, "cpu")


def _wave(seed, batch, n):
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.3).astype(np.float32)


def test_logmel_f32_matches_pallas_k1_with_edge_padding():
    _, jp, _, pp = _pair("HIGHEST")
    wave = _wave(2, 2, pp.clip_samples)
    n_valid = np.asarray([pp.clip_samples, pp.clip_samples // 3], np.int32)
    want = np.asarray(jax_log_mel(jnp.asarray(wave), jp, n_valid_samples=jnp.asarray(n_valid)))
    got = log_mel_spectrogram(torch.from_numpy(wave), pp, torch.from_numpy(n_valid)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_logmel_f32_matches_numpy_oracle():
    _, _, pcfg, pp = _pair("HIGHEST")
    wave = _wave(1, 3, pp.clip_samples)
    got = log_mel_spectrogram(torch.from_numpy(wave), pp).numpy()
    want = np.stack([
        port_ref.pad_to_num_frames(port_ref.log_mel_np(pcfg, w), pcfg.AUDIO_DATA.NUM_FRAMES)
        for w in wave
    ])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # the port's copy of the oracle is the JAX package's, bit for bit
    jcfg = _small(jax_get_cfg())
    np.testing.assert_array_equal(port_ref.log_mel_np(pcfg, wave[0]), jax_ref.log_mel_np(jcfg, wave[0]))


def test_logmel_bf16_matches_pallas_k2():
    """Both sides round the waveform, basis, mel matrix and magnitude to bf16
    and accumulate in float32: only the summation order differs."""
    _, jp, _, pp = _pair("BFLOAT16")
    assert jp.fast and pp.fast
    wave = _wave(3, 2, pp.clip_samples)
    n_valid = np.asarray([pp.clip_samples, pp.clip_samples // 3], np.int32)
    want = np.asarray(jax_log_mel(jnp.asarray(wave), jp, n_valid_samples=jnp.asarray(n_valid)))
    got = log_mel_spectrogram(torch.from_numpy(wave), pp, torch.from_numpy(n_valid)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-3


def test_flagship_support_and_weights():
    """24 kHz, n_fft 2048, win 240: the kernels contract over the 256-tap
    aligned window support (tests/test_pallas_logmel.py:166-168)."""
    p = LogMelParams(flagship_cfg(), "cpu")
    assert p.support == (905, 1144)
    assert (p.s0a, p.s1a, p.ksup) == (896, 1152, 256)
    assert (p.hop, p.off, p.clip_samples) == (120, -128, 30695)
    # the DC bin feeds no mel bin: the basis holds frequencies 1..1024
    assert p.freqs == (1, 1025)
    assert tuple(p.w_cos.shape) == (256, 1024) and tuple(p.mel_w.shape) == (1024, 128)
    assert p.geometry(p.clip_samples)["n_frames"] == 256


def test_frames_of_matches_centre_padded_framing():
    """frame t, tap c = x[t*hop + off + c]: the centre padding and the support trim."""
    rng = np.random.default_rng(5)
    n_fft, hop, t = 64, 12, 30
    wave = rng.standard_normal((2, 300)).astype(np.float32)
    padded = np.pad(wave, ((0, 0), (n_fft // 2, n_fft + t * hop)))
    for s0, s1 in [(0, 64), (25, 39), (50, 64)]:
        got = ops.frames_of(torch.from_numpy(wave), s1 - s0, hop, s0 - n_fft // 2, t).numpy()
        want = np.stack([
            np.stack([padded[b, i * hop + s0 : i * hop + s1] for i in range(t)]) for b in range(2)
        ])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", ["HIGHEST", "BFLOAT16"])
def test_wrapper_takes_plain_version_on_cpu(precision):
    _, _, _, pp = _pair(precision)
    wave = torch.from_numpy(_wave(4, 2, pp.clip_samples)).to(pp.dtype)
    wrapper, plain = (ops.logmel_bf16, ops.logmel_bf16_plain) if pp.fast else (
        ops.logmel_f32, ops.logmel_f32_plain)
    before = wrapper.launches
    got = wrapper(wave, pp.w_cos, pp.w_sin, pp.mel_w, **pp.geometry(wave.shape[1]))
    want = plain(wave, pp.w_cos, pp.w_sin, pp.mel_w, **pp.geometry(wave.shape[1]))
    assert wrapper.launches == before  # no kernel launched for a CPU tensor
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments():
    _, _, _, pp = _pair("HIGHEST")
    wave = torch.zeros(2, pp.clip_samples)
    geo = pp.geometry(pp.clip_samples)
    with pytest.raises(TypeError):
        ops.logmel_f32(wave.double(), pp.w_cos, pp.w_sin, pp.mel_w, **geo)
    with pytest.raises(TypeError):
        ops.logmel_bf16(wave, pp.w_cos, pp.w_sin, pp.mel_w, **geo)
    with pytest.raises(ValueError):
        ops.logmel_f32(wave.t(), pp.w_cos, pp.w_sin, pp.mel_w, **geo)
    with pytest.raises(ValueError):
        ops.logmel_f32(wave, pp.w_cos, pp.w_sin, pp.mel_w[:, :64].contiguous(), **geo)
    with pytest.raises(ValueError):
        ops.logmel_f32(wave, pp.w_cos, pp.w_sin, pp.mel_w, **{**geo, "n_mels": 129})
    with pytest.raises(ValueError):
        ops.logmel_f32(wave, pp.w_cos, pp.w_sin, pp.mel_w, **{**geo, "hop": 0})


@pytest.mark.parametrize("alpha", [2, 4, 8])
def test_slow_indices_match_jax_and_torch_linspace(alpha):
    for t in range(2, 513):
        got = slow_indices(t, alpha)
        np.testing.assert_array_equal(got, jax_slow_indices(t, alpha))
        want = torch.linspace(0, t - 1, t // alpha).long().numpy()
        np.testing.assert_array_equal(got, want)
