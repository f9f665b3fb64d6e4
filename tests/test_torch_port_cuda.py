"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

Elsewhere every test here skips. The skip condition is a string, which
pytest evaluates when each test runs, not when the module is imported.
"""

import numpy as np
import pytest
import torch

from asf_tpu_torch.dsp.logmel import LogMelParams
from asf_tpu_torch.entry import flagship_cfg, wide_window
from asf_tpu_torch.ops import logmel as ops
from asf_tpu_torch.utils.torch_setup import disable_tf32

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="the CUDA kernels need a GPU"),
]


def _params(precision, wide=False):
    disable_tf32()
    cfg = wide_window(flagship_cfg()) if wide else flagship_cfg()
    cfg.GPU.DSP_PRECISION = precision
    return LogMelParams(cfg, "cuda")


def _wave(p, batch):
    """Seeded waveforms; the last record is short (n_valid = S/3, zeros after)."""
    wave = np.random.default_rng(6).standard_normal((batch, p.clip_samples)).astype(np.float32)
    wave[-1, p.clip_samples // 3 :] = 0.0
    return torch.from_numpy(wave * 0.1).cuda().to(p.dtype)


# (kernel, precision, wide): K1 and K2 at the flagship's 256-tap support and
# at the wide window's 2048 taps (tiled in chunks of 256), K3 at 2048 taps.
CASES = [
    ("logmel_f32", "HIGHEST", False),
    ("logmel_bf16", "BFLOAT16", False),
    ("logmel_f32", "HIGHEST", True),
    ("logmel_bf16", "BFLOAT16", True),
    ("logmel_bf16_wide", "BFLOAT16", True),
]


@pytest.mark.parametrize("name,precision,wide", CASES)
def test_kernel_matches_plain_version(name, precision, wide):
    p = _params(precision, wide)
    assert p.ksup == (2048 if wide else 256)
    wave = _wave(p, 4)
    wrapper, plain = getattr(ops, name), getattr(ops, f"{name}_plain")
    geo = p.geometry(p.clip_samples)
    before = wrapper.launches
    got = wrapper(wave, p.w_cos, p.w_sin, p.mel_w, **geo)
    want = plain(wave, p.w_cos, p.w_sin, p.mel_w, **geo)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got.shape == want.shape == (4, 256, 128)
    err = (got - want).abs()
    if p.fast:  # the same bf16 roundings; only the summation order differs
        assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-6
        # nearer the plain version than the same inputs without the
        # magnitude rounded to bf16, which a kernel skipping it would match
        unrounded = ops.logmel_f32_plain(wave, p.w_cos, p.w_sin, p.mel_w, **geo)
        assert err.mean().item() < (got - unrounded).abs().mean().item()
    else:
        assert err.max().item() <= 1e-4


def test_kernel_rejects_weights_on_another_device():
    p = _params("HIGHEST")
    with pytest.raises(ValueError):
        ops.logmel_f32(_wave(p, 1), p.w_cos.cpu(), p.w_sin, p.mel_w,
                       **p.geometry(p.clip_samples))
