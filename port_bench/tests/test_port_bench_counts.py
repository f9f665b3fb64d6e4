"""The operation and byte counts against hand counts at a tiny size, and the
per-layer readers on runs they can and cannot read."""

from __future__ import annotations

import types

import pytest

from port_bench import flops, readers

TINY = {"sampling_rate": 8000, "n_fft": 256, "window_ms": 10.0, "hop_ms": 5.0, "n_mels": 32,
        "num_frames": 256, "clip_s": 1.279, "overlap_s": 0.1, "max_windows": 8, "depth": 26,
        "width": 8, "beta_inv": 8, "alpha": 8, "fusion_ratio": 2, "fusion_kernel": 5,
        "num_block_temp_kernel": [[3, 3], [4, 4], [6, 6], [3, 3]],
        "frequency_strides": [[1, 1], [2, 2], [2, 2], [2, 2]],
        "frequency_dilations": [[1, 1], [1, 1], [1, 1], [1, 1]],
        "num_classes": [97, 300], "dropout": 0.5, "gru_layers": 0, "gru_hidden": 16,
        "compute_dtype": "bfloat16", "dsp_bf16": True}


def test_stem_and_head_by_hand():
    f = flops.model_flops(TINY, 2)
    # slow stem: 2 rows x 8 channels x (32/2) x (32/2) outputs x 7 taps x 2
    slow_stem = 2 * 8 * 16 * 16 * 7 * 2
    # fast stem: 2 x 1 channel x 128 x 16 outputs x (5 x 7) taps x 2
    fast_stem = 2 * 1 * 128 * 16 * 35 * 2
    assert f["conv"] > slow_stem + fast_stem
    # head: 2 rows, 1 x 1 positions, 288 features to 97 + 300 classes
    assert f["linear"] == 2 * 2 * 288 * (97 + 300)
    assert f["gru"] == 0


def test_conv_count_is_linear_in_rows():
    assert flops.model_flops(TINY, 6)["conv"] == 3 * flops.model_flops(TINY, 2)["conv"]


def test_gru_count_by_hand():
    m = dict(TINY, gru_layers=2, gru_hidden=16)
    f = flops.model_flops(m, 2 * 4, (2, 4), [3, 1])
    h, feat, real = 16, 288, 4
    per = lambda i: 2 * real * 3 * h * (i + h)  # noqa: E731
    assert f["gru"] == 2 * per(feat) + 2 * per(2 * h)
    # projection to the trunk's width and the two heads, on every window
    assert f["linear"] == 2 * 8 * (2 * h * feat + feat * (97 + 300))
    # the trunk over the 4 real windows of the 8 the batch computes
    assert f["conv"] == flops.model_flops(TINY, 4)["conv"]


def test_logmel_work_by_hand():
    ops, nbytes = flops.logmel_work(TINY, 4)
    samples = int(round(8000 * 1.279)) - 1
    frames = 4 * (1 + samples // 40)
    taps, freqs = 79, 127  # a Hann window of 80 has one zero; the DC bin feeds no mel
    assert ops == frames * (2 * 2 * taps * freqs + 2 * freqs * 32)
    assert nbytes == 4 * samples * 2 + 2 * taps * freqs * 2 + freqs * 32 * 2 + frames * 32 * 4
    bound = flops.logmel_bound_s(TINY, 4, (67e12, 989e12, 3.35e12))
    assert bound == pytest.approx(max(ops / 989e12, nbytes / 3.35e12))


def _run(trace=None, traced=()):
    calls = [(0.0, 0.001, 8, 8, 1, 8, "window"), (0.003, 0.004, 8, 8, 1, 8, "window"),
             (0.006, 0.007, 16, 4, 4, 10, "window")]
    spans = types.SimpleNamespace(calls=calls, lengths=[None, None, [4, 2, 2, 2]])
    return types.SimpleNamespace(trace=trace, peaks=(67e12, 989e12, 3.35e12), gaps_s=[0.01] * 3,
                                 window_calls=[0, 1, 2], traced=set(traced), spans=spans,
                                 m=TINY, ideal_s=lambda i: 0.001)


def test_readers_with_nothing_to_read():
    run = _run()
    assert readers.idle(run) is None
    assert readers.logmel_roofline(run) is None
    assert readers.device_ms(run, patterns=readers.BN_PATTERNS) is None


def test_readers_by_hand():
    trace = {"busy_s": 0.3, "window_s": 0.4, "device_events": 5, "steps": 2,
             "kernels": {"bn_fw_tr_1C11": 0.002, "sm90_gemm": 0.01}, "logmel": [0.001, 0.003],
             "logmel_reduce_s": 0.0, "ops": {"aten::_cudnn_rnn": 0.004}}
    run = _run(trace, traced=[2])
    assert readers.idle(run) == pytest.approx(25.0)
    assert readers.device_ms(run, patterns=readers.BN_PATTERNS) == pytest.approx(1.0)
    assert readers.device_ms(run, ops=readers.GRU_OPS) == pytest.approx(2.0)
    assert readers.mfu(run) == pytest.approx(10.0)  # 2 untraced steps, 1 ms ideal in 10 ms
    assert readers.pad_share(run) == pytest.approx(100.0 * 6 / 32)
    assert readers.host_ms(run) == pytest.approx(1.0)
    assert readers.host_ms(run, between=True) == pytest.approx(2.0)
    bound = flops.logmel_bound_s(TINY, 16, run.peaks)
    assert readers.logmel_roofline(run) == pytest.approx(100.0 * bound / 0.002)
    # K1's slice reduction, where a launch has one, is part of the launch
    run.trace = dict(trace, logmel_reduce_s=0.002)
    assert readers.logmel_roofline(run) == pytest.approx(100.0 * bound / 0.003)
