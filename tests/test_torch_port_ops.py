"""CPU tests of the port's kernel plumbing: the build's cache key, and the
model of the bf16 tensor-core kernel's summation (``tc_matmul``)."""

from fractions import Fraction

import numpy as np
import torch

from asf_tpu_torch.ops import _build
from asf_tpu_torch.ops import logmel as ops


def test_library_path_follows_every_source_file_and_the_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    paths = [_build.library_path("k")]
    assert _build.library_path("k") == paths[0]
    assert paths[0].parent == _build.BUILD_DIR and paths[0].name.startswith("k-")
    (csrc / "h.cuh").write_text("// two\n")  # an edited header
    paths.append(_build.library_path("k"))
    (csrc / "g.cuh").write_text("")  # a new header
    paths.append(_build.library_path("k"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    paths.append(_build.library_path("k"))
    assert len(set(paths)) == len(paths)


def _bf16(rng, shape, spread):
    """bf16 values whose exponents span ``spread`` binades."""
    x = rng.standard_normal(shape) * 2.0 ** rng.integers(-spread, spread + 1, shape)
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float()


def _reference(a, b, rounding):
    """Each group of TC_GROUP consecutive products summed exactly, rounded to
    float32 by ``rounding`` ("zero" or "nearest"), the partial sums added in
    order in float32 from zero."""
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = np.float32(0.0)
            for k0 in range(0, a.shape[1], ops.TC_GROUP):
                s = sum(Fraction(float(a[i, k])) * Fraction(float(b[k, j]))
                        for k in range(k0, min(k0 + ops.TC_GROUP, a.shape[1])))
                part = np.float32(float(s))  # nearest
                if rounding == "zero" and abs(Fraction(float(part))) > abs(s):
                    part = np.nextafter(part, np.float32(0.0))
                acc = np.float32(acc + part)
            out[i, j] = acc
    return out


def test_tc_matmul_rounds_each_group_toward_zero_then_adds_in_order():
    rng = np.random.default_rng(0)
    a, b = _bf16(rng, (6, 40), 6), _bf16(rng, (40, 5), 6)  # 40: a short last group
    got = ops.tc_matmul(a, b).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, _reference(a.numpy(), b.numpy(), "zero"))
    # The rounding direction is what the test tells apart.
    assert (got != _reference(a.numpy(), b.numpy(), "nearest")).any()
    # A leading batch dimension, as the frames of the plain version have.
    np.testing.assert_array_equal(ops.tc_matmul(a.reshape(2, 3, 40), b).numpy(),
                                  got.reshape(2, 3, 5))


def test_toward_zero_never_rounds_away():
    rng = np.random.default_rng(1)
    s = torch.from_numpy(rng.standard_normal(4096) * 2.0 ** rng.integers(-30, 30, 4096))
    f = ops._toward_zero(s)
    assert f.dtype == torch.float32
    assert bool((f.double().abs() <= s.abs()).all())
    # within one float32 step of the value, and exact where float32 holds it
    assert bool((torch.nextafter(f, f * 2).double().abs() >= s.abs()).all())
    exact = s.float().double()
    np.testing.assert_array_equal(ops._toward_zero(exact).numpy(), exact.float().numpy())


def test_tc_model_is_within_the_bf16_gate_of_the_plain_version():
    """The model of the kernel's summation and the float32 plain version
    differ only where a bf16 rounding of the magnitude flips."""
    from asf_tpu_torch.config import get_cfg
    from asf_tpu_torch.dsp.logmel import LogMelParams

    cfg = get_cfg()
    cfg.AUDIO_DATA.SAMPLING_RATE = 4000
    cfg.AUDIO_DATA.N_FFT = 256
    cfg.AUDIO_DATA.CLIP_SECS = 0.5
    cfg.GPU.DSP_PRECISION = "BFLOAT16"
    p = LogMelParams(cfg, "cpu")
    wave = np.random.default_rng(3).standard_normal((2, p.clip_samples)) * 0.3
    args = (torch.from_numpy(wave.astype(np.float32)).to(torch.bfloat16), p.w_cos, p.w_sin,
            p.mel_w)
    geo = p.geometry(p.clip_samples)
    want = ops.logmel_bf16_plain(*args, **geo)
    got = ops.logmel_bf16_tc_model(*args, **geo)
    assert got.shape == want.shape == (2, geo["n_frames"], geo["n_mels"])
    err = (got - want).abs()
    assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-6
