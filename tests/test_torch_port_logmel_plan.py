"""CPU tests of ``logmel_f32``'s launch plan and of the eval-probability gate.

The plan (``ops.f32_plan``: frequency slices, given the frames a block
that the kernel's shared memory allows) is plain Python; the kernel it drives runs only on the card
(``tests/test_torch_port_cuda.py``). The gate of ``chip_smoke.py`` judges
two spectrograms through a float32 copy of the served bf16 model; here it
is rehearsed at the tiny test geometry of ``test_torch_port_entry``.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from asf_tpu_torch.dsp.logmel import LogMelParams, log_mel_spectrogram
from asf_tpu_torch.engine.pipeline import pack_pathways
from asf_tpu_torch.entry import entry, flagship_cfg, wide_window
from asf_tpu_torch.models.layers import Conv2d
from asf_tpu_torch.ops import logmel as ops
from test_torch_port_entry import tiny

H100_SMS = 132


def _geometry(wide):
    cfg = wide_window(flagship_cfg()) if wide else flagship_cfg()
    cfg.GPU.DSP_PRECISION = "HIGHEST"
    p = LogMelParams(cfg, "cpu")
    geo = p.geometry(p.clip_samples)
    return geo["n_frames"], p.ksup, p.w_cos.shape[1]


# Both geometries take 128 frames a block on the card
# (tests/test_torch_port_cuda.py:test_f32_kernel_plan_branches).
@pytest.mark.parametrize("wide", [False, True])
def test_f32_plan_fills_a_wave_at_batch_8_and_splits_nothing_at_128(wide):
    n_frames, ksup, kf = _geometry(wide)
    assert (n_frames, ksup, kf) == (256, 2048 if wide else 256, 1024)
    splits = ops.f32_plan(8, n_frames, 128, kf, H100_SMS)
    blocks = 8 * -(-n_frames // 128) * splits
    assert splits > 1
    last_wave = blocks % H100_SMS or H100_SMS
    assert last_wave >= 0.9 * H100_SMS, f"{blocks} blocks fill {last_wave} of {H100_SMS} SMs"
    assert ops.f32_plan(128, n_frames, 128, kf, H100_SMS) == 1


@pytest.mark.parametrize("kf", [64, 1088, 1152])
def test_f32_slices_cover_kf_in_whole_nonempty_chunks(kf):
    for splits in range(1, kf // ops.FREQ_CHUNK + 1):
        slices = ops.f32_slices(kf, splits)
        assert len(slices) == splits
        assert slices[0][0] == 0 and slices[-1][1] == kf
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        widths = [k1 - k0 for k0, k1 in slices]
        assert all(w > 0 and w % ops.FREQ_CHUNK == 0 for w in widths)
        assert max(widths) - min(widths) <= ops.FREQ_CHUNK  # as even as whole chunks go


def test_f32_plan_keeps_splits_in_range():
    rng = np.random.default_rng(0)
    for _ in range(300):
        batch = int(rng.integers(1, 300))
        n_frames = int(rng.integers(1, 600))
        frames = int(rng.choice([1, 2, 4, 8, 16, 32, 64, 128]))
        kf = int(rng.choice([64, 640, 1088, 1152]))
        n_sms = int(rng.choice([1, 114, 132]))
        splits = ops.f32_plan(batch, n_frames, frames, kf, n_sms)
        assert 1 <= splits <= kf // ops.FREQ_CHUNK
        tiles = batch * -(-n_frames // frames)
        if tiles >= n_sms:
            assert splits == 1
        else:  # one wave, unless the frequency chunks run out first
            assert tiles * splits <= n_sms
            assert splits == kf // ops.FREQ_CHUNK or tiles * (splits + 1) > n_sms


def test_wrapper_takes_the_plain_version_on_the_cpu():
    p = LogMelParams(tiny(flagship_cfg()), "cpu")
    wave = torch.from_numpy(np.random.default_rng(1).standard_normal((2, p.clip_samples))
                            .astype(np.float32))
    args, geo = (wave, p.w_cos, p.w_sin, p.mel_w), p.geometry(p.clip_samples)
    before = ops.logmel_f32.launches
    torch.testing.assert_close(ops.logmel_f32(*args, **geo), ops.logmel_f32_plain(*args, **geo),
                               rtol=0, atol=0)
    assert ops.logmel_f32.launches == before  # only a launch on the card counts


@pytest.fixture(scope="module")
def served():
    """A tiny bf16 model behind the float32 front end, as the eval slice serves it."""
    cfg = tiny(flagship_cfg())
    fn, (model, _, _) = entry(batch=2, device="cpu", cfg=cfg)
    return fn.pipeline, model


def test_float32_copy_holds_the_served_models_weights(served):
    pipe, model = served
    assert model.s1.pathway0_stem.conv.compute_dtype == torch.bfloat16
    twin = chip_smoke.float32_copy(model, pipe.cfg)
    assert not twin.training
    convs = [m for m in twin.modules() if isinstance(m, Conv2d)]
    assert convs and all(m.compute_dtype == torch.float32 for m in convs)
    want, got = model.state_dict(), twin.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_float32_judge_is_well_conditioned(served):
    """A relative change of 1e-6 of the log-mel moves the float32 model's
    probabilities by far less than the gate's 1e-3, and the gate's control
    (the log-mel 1 % off) by far more than that; the bf16 model's move is
    printed."""
    pipe, model = served
    twin = chip_smoke.float32_copy(model, pipe.cfg)
    p = pipe.params
    rng = np.random.default_rng(2)
    wave = torch.from_numpy((rng.standard_normal((2, p.clip_samples)) * 0.1).astype(np.float32))
    n_valid = torch.tensor([p.clip_samples, p.clip_samples // 3], dtype=torch.int32)
    spec = log_mel_spectrogram(wave, p, n_valid, out_frames=pipe.cfg.AUDIO_DATA.NUM_FRAMES)
    noise = torch.from_numpy(rng.choice([-1.0, 1.0], spec.shape).astype(np.float32))
    paths = pack_pathways(pipe.cfg, spec)
    moved = pack_pathways(pipe.cfg, spec * (1 + 1e-6 * noise))
    control = pack_pathways(pipe.cfg, spec * (1 + chip_smoke.CONTROL))
    assert all(torch.equal(a, b) for a, b in zip(paths, pipe(wave, n_valid)))
    with torch.inference_mode():
        want = twin(paths)
        diff32 = (want - twin(moved)).abs().max().item()
        diff_control = (want - twin(control)).abs().max().item()
        with torch.backends.mkldnn.flags(enabled=False):  # ROADMAP §3: oneDNN bf16 on the CPU
            diff16 = (model(paths) - model(moved)).abs().max().item()
    print(f"relative 1e-6 on the log-mel: float32 model {diff32:.3g}, bf16 model {diff16:.3g}; "
          f"the control: float32 model {diff_control:.3g}")
    assert 0 < diff32 < 1e-4
    assert diff_control > 100 * diff32
