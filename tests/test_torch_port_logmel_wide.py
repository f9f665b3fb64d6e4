"""The port's log-mel front end at a wide window support, against the JAX package.

Wide-window geometry: the flagship's 24 kHz and n_fft 2048 with
``WINDOW_LENGTH = 2048/24`` ms (``win_length = n_fft``, librosa's default)
and ``HOP_LENGTH = 1928/24`` ms, an effective hop of 120 through the
reference's ``hop = win - hop`` rule. The aligned support is 2048 taps, so
``PallasLogMel`` picks K3 ``_hopblock_logmel`` for the bf16 front end, and
K1 ``_partial_mel`` for the float32 one. Clips are cut to 0.3 s
(``tests/test_pallas_logmel.py:92-119``) to keep the interpret mode short.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asf_tpu.config import get_cfg as jax_get_cfg
from asf_tpu.dsp.logmel import LogMelParams as JaxLogMelParams
from asf_tpu.dsp.logmel import log_mel_spectrogram as jax_log_mel
from asf_tpu_torch.config import get_cfg
from asf_tpu_torch.dsp.logmel import LogMelParams, log_mel_spectrogram
from asf_tpu_torch.entry import wide_window
from asf_tpu_torch.ops import logmel as ops


def _short(cfg):
    cfg.AUDIO_DATA.CLIP_SECS = 0.3
    cfg.AUDIO_DATA.NUM_FRAMES = 61
    return cfg


def _pair(precision):
    jcfg = _short(wide_window(jax_get_cfg()))
    jcfg.TPU.USE_PALLAS_DSP = True
    jcfg.TPU.DSP_PRECISION = precision
    pcfg = _short(wide_window(get_cfg()))
    pcfg.GPU.DSP_PRECISION = precision
    return JaxLogMelParams(jcfg), LogMelParams(pcfg, "cpu")


def _inputs(seed, pp):
    wave = np.random.default_rng(seed).standard_normal((2, pp.clip_samples)) * 0.2
    n_valid = np.asarray([pp.clip_samples, pp.clip_samples // 3], np.int32)
    return wave.astype(np.float32), n_valid


def _both(jp, pp, wave, n_valid):
    want = np.asarray(jax_log_mel(jnp.asarray(wave), jp, n_valid_samples=jnp.asarray(n_valid)))
    got = log_mel_spectrogram(torch.from_numpy(wave), pp, torch.from_numpy(n_valid)).numpy()
    assert got.shape == want.shape == (2, 61, 128)
    return got, want


def test_wide_geometry():
    jp, pp = _pair("BFLOAT16")
    assert (pp.win, pp.hop) == (2048, 120)
    assert pp.support == (1, 2048) and pp.ksup == 2048 and pp.off == -1024
    assert (jp.pallas.j_lo, jp.pallas.j_eff) == (0, 18) and pp.j_eff == 18
    assert jp.pallas.hopblock and pp.hopblock
    full = wide_window(get_cfg())
    assert LogMelParams(full, "cpu").geometry(30695)["n_frames"] == 256


def test_bf16_wide_matches_pallas_k3_with_edge_padding():
    """K3 in interpret mode against the port's ``logmel_bf16_wide`` (its
    plain version here): both round the waveform, basis, mel matrix and
    magnitude to bf16 and accumulate in float32; only the summation order
    differs, and a magnitude whose rounding flips moves a bin by < 4e-3."""
    jp, pp = _pair("BFLOAT16")
    wave, n_valid = _inputs(5, pp)
    assert pp.kernel(pp.geometry(wave.shape[1])["n_frames"]) is ops.logmel_bf16_wide
    got, want = _both(jp, pp, wave, n_valid)
    assert np.max(np.abs(got - want)) <= 1e-3


def test_f32_wide_matches_pallas_k1():
    """The repaired float32 path at a 2048-tap support against K1."""
    jp, pp = _pair("HIGHEST")
    assert jp.pallas.ksup == 2048 and not jp.pallas.resident
    wave, n_valid = _inputs(6, pp)
    assert pp.kernel(pp.geometry(wave.shape[1])["n_frames"]) is ops.logmel_f32
    got, want = _both(jp, pp, wave, n_valid)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# (window samples, effective hop samples) at 24 kHz, n_fft 2048: each of K3's
# conditions on both sides. Supports: 240 -> 256 taps, 512 -> 512, 600 -> 768,
# 1024 -> 1024, 2048 -> 2048; hop 60 at 1024 taps pads to 18 blocks of 128
# (2.25x the taps), hop 129 is past the 128 limit.
_GRID = [(w, h) for w in (240, 512, 600, 1024, 2048) for h in (60, 120, 128, 129, 200) if h < w]


@pytest.mark.parametrize("precision", ["HIGHEST", "BFLOAT16"])
def test_kernel_choice_follows_pallas_hopblock(precision):
    chosen, refused = set(), set()
    for win, hop in _GRID:
        jcfg, pcfg = jax_get_cfg(), get_cfg()
        for cfg in (jcfg, pcfg):
            cfg.AUDIO_DATA.WINDOW_LENGTH = win / 24
            cfg.AUDIO_DATA.HOP_LENGTH = (win - hop) / 24
        jcfg.TPU.USE_PALLAS_DSP = True
        jcfg.TPU.DSP_PRECISION = precision
        pcfg.GPU.DSP_PRECISION = precision
        pp = LogMelParams(pcfg, "cpu")
        try:
            jp = JaxLogMelParams(jcfg).pallas
        except ValueError as e:
            # asf_tpu builds K3's hop-block basis for every bf16 front end; a
            # hop wider than its 128 lanes overruns the last block unless the
            # support has room after it (logmel_pallas.py:403-410). The port
            # takes K2 there.
            assert "broadcast" in str(e) and precision == "BFLOAT16" and hop > 128
            assert not pp.hopblock and pp.kernel(61) is ops.logmel_bf16
            refused.add((win, hop))
            continue
        assert (pp.hop, pp.ksup) == (jp.hop, jp.ksup)
        assert pp.hopblock == jp.hopblock, (win, hop)
        for n_frames in (61, 505, 513):  # padded to 8: 64, 512, 520 (K3 takes <= 512)
            k3 = jp.hopblock and -(-n_frames // 8) * 8 <= 512
            want = ops.logmel_bf16_wide if k3 else (
                ops.logmel_bf16 if jp.resident else ops.logmel_f32)
            assert pp.kernel(n_frames) is want, (win, hop, n_frames)
            chosen.add(want.__name__)
    if precision == "BFLOAT16":
        assert chosen == {"logmel_bf16", "logmel_bf16_wide"} and len(refused) == 8
    else:
        assert chosen == {"logmel_f32"} and not refused


def test_wide_wrapper_takes_plain_version_on_cpu_and_refuses_grad():
    _, pp = _pair("BFLOAT16")
    wave = torch.from_numpy(_inputs(7, pp)[0]).to(torch.bfloat16)
    geo = pp.geometry(wave.shape[1])
    before = ops.logmel_bf16_wide.launches
    got = ops.logmel_bf16_wide(wave, pp.w_cos, pp.w_sin, pp.mel_w, **geo)
    want = ops.logmel_bf16_wide_plain(wave, pp.w_cos, pp.w_sin, pp.mel_w, **geo)
    assert ops.logmel_bf16_wide.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # no backward in any of the kernels: an input that requires grad is refused
    with pytest.raises(ValueError, match="requires grad"):
        ops.logmel_bf16_wide(wave.float().requires_grad_().to(torch.bfloat16), pp.w_cos,
                             pp.w_sin, pp.mel_w, **geo)
    with pytest.raises(TypeError):
        ops.logmel_bf16_wide(wave.float(), pp.w_cos, pp.w_sin, pp.mel_w, **geo)
