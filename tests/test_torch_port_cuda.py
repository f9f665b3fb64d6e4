"""The port's CUDA kernels against their plain PyTorch versions, on the card;
the prefetcher's stream handling (fed by loader worker processes too) and
the launches of ``train(cfg)`` and ``test(cfg)``, for VGG-Sound, for
EPIC-KITCHENS verb/noun (its sliding windows too), for the GRU sequence model
and for the single-pathway ResNet; the tensor-parallel autograd Functions on
two gloo ranks on the card.

Imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

Elsewhere every test here skips. The skip condition is a string, which
pytest evaluates when each test runs, not when the module is imported.
"""

import os
import pickle

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from asf_tpu_torch.data.loader import construct_loader, shuffle_dataset
from asf_tpu_torch.data.prefetch import Prefetcher, prefetch
from asf_tpu_torch.dsp.logmel import LogMelParams
from asf_tpu_torch.engine import test as run_test
from asf_tpu_torch.engine import train
from asf_tpu_torch.entry import epic_cfg, flagship_cfg, wide_window
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


def _held_to_plain(name, p, wave, geo, splits=None):
    """Launches kernel ``name`` once through its wrapper, or ``logmel_f32``'s
    in ``splits`` frequency slices, and holds it to its plain version;
    returns what the kernel gave."""
    wrapper, plain = getattr(ops, name), getattr(ops, f"{name}_plain")
    args = (wave, p.w_cos, p.w_sin, p.mel_w)
    before = wrapper.launches
    got = wrapper(*args, **geo) if splits is None else ops._launch_f32(*args, **geo,
                                                                       splits=splits)
    want = plain(*args, **geo)
    torch.cuda.synchronize()
    assert wrapper.launches == before + (splits is None)
    assert got.shape == want.shape == (wave.shape[0], geo["n_frames"], 128)
    err = (got - want).abs()
    if p.fast:  # the same bf16 roundings; only the summation order differs
        assert err.max().item() <= 1e-2 and err.mean().item() <= 1e-6
        # nearer the plain version than the same inputs without the
        # magnitude rounded to bf16, which a kernel skipping it would match
        unrounded = ops.logmel_f32_plain(*args, **geo)
        assert err.mean().item() < (got - unrounded).abs().mean().item()
    else:
        assert err.max().item() <= 1e-4
    return got


@pytest.mark.parametrize("name,precision,wide", CASES)
def test_kernel_matches_plain_version(name, precision, wide):
    p = _params(precision, wide)
    assert p.ksup == (2048 if wide else 256)
    _held_to_plain(name, p, _wave(p, 4), p.geometry(p.clip_samples))


@pytest.mark.parametrize("batch", [16, 32, 320])
def test_bf16_kernel_at_the_epic_geometry(batch):
    """EPIC-KITCHENS clips: 47,975 samples -> 400 frames, three 128-frame
    tiles and a 16-frame tail; B = 32 trains, B = 16 is the ragged val batch,
    320 rows are the GRU's 16 chains of 20 windows."""
    disable_tf32()
    cfg = epic_cfg()
    p = LogMelParams(cfg, "cuda")
    geo = p.geometry(p.clip_samples)
    assert p.clip_samples == 47975 and geo["n_frames"] == 400 and p.fast
    _held_to_plain("logmel_bf16", p, _wave(p, batch), geo)


# (batch, n_frames, hop, off) away from the main paths' shapes for the bf16
# tensor-core kernel (128-frame tiles): frame counts that are not a multiple
# of the tile, one sample, hops that are not a multiple of 8 (121 is odd, so
# half the frame rows start on an odd sample), and a positive offset beside
# the geometry's negative one. None keeps the geometry's value; every wave
# has the short last record of ``_wave``.
EDGE_CASES = [
    (1, None, None, None),
    (3, 200, None, None),
    (3, 257, None, None),
    (2, None, 100, None),
    (2, None, 121, None),
    (2, None, None, 37),
    (2, 257, 121, 37),
]


@pytest.mark.parametrize("name,wide", [("logmel_bf16", False), ("logmel_bf16_wide", True)])
@pytest.mark.parametrize("batch,n_frames,hop,off", EDGE_CASES)
def test_bf16_kernel_edge_cases(name, wide, batch, n_frames, hop, off):
    p = _params("BFLOAT16", wide)
    geo = p.geometry(p.clip_samples)
    assert geo["off"] < 0
    if hop is not None:
        geo.update(hop=hop, n_frames=1 + p.clip_samples // hop)
    if n_frames is not None:
        geo["n_frames"] = n_frames
    if off is not None:
        geo["off"] = off
    _held_to_plain(name, p, _wave(p, batch), geo)


# Hops whose span of 128 frames does not fit a block's shared memory at
# either support: the bf16 kernel takes fewer frames per block (64 at 700
# and at the odd 331, 16 at the odd 2001), where the main paths' geometries
# take 128.
WIDE_HOPS = [700, 331, 2001]


@pytest.mark.parametrize("name,wide", [("logmel_bf16", False), ("logmel_bf16_wide", True)])
@pytest.mark.parametrize("hop", WIDE_HOPS)
def test_bf16_kernel_wide_hops(name, wide, hop):
    p = _params("BFLOAT16", wide)
    geo = p.geometry(p.clip_samples)
    assert ops.tc_frames_per_block(geo["hop"], p.ksup) == 128
    geo.update(hop=hop, n_frames=1 + p.clip_samples // hop)
    assert ops.tc_frames_per_block(hop, p.ksup) < 128
    _held_to_plain(name, p, _wave(p, 2), geo)


def test_kernel_rejects_weights_on_another_device():
    p = _params("HIGHEST")
    with pytest.raises(ValueError):
        ops.logmel_f32(_wave(p, 1), p.w_cos.cpu(), p.w_sin, p.mel_w,
                       **p.geometry(p.clip_samples))


# logmel_f32's two branches: its plan's choice (one frequency slice at
# B = 128, several at B = 1 and 8), one slice, and 7 slices, which split the
# 16 chunks of 64 frequencies (kf = 1024) unevenly (2 or 3 a slice).
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("splits", [None, 1, 7])
def test_f32_kernel_plan_branches(wide, batch, splits):
    p = _params("HIGHEST", wide)
    geo = p.geometry(p.clip_samples)
    frames, planned = ops.f32_device_plan(batch, geo["n_frames"], geo["hop"], p.ksup,
                                          p.w_cos.shape[1], "cuda")
    assert frames == 128 and (planned == 1) == (batch == 128)
    _held_to_plain("logmel_f32", p, _wave(p, batch), geo, splits=splits)


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("batch,n_frames,hop,off", EDGE_CASES)
def test_f32_kernel_edge_cases(batch, n_frames, hop, off, splits):
    p = _params("HIGHEST")
    geo = p.geometry(p.clip_samples)
    if hop is not None:
        geo.update(hop=hop, n_frames=1 + p.clip_samples // hop)
    if n_frames is not None:
        geo["n_frames"] = n_frames
    if off is not None:
        geo["off"] = off
    _held_to_plain("logmel_f32", p, _wave(p, batch), geo, splits=splits)


# Hops whose span of 128 frames overflows shared memory: the float32
# kernel's blocks take fewer frames (64 at 331, 32 at 700, 8 at 2001 at the
# wide support).
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("hop", WIDE_HOPS)
def test_f32_kernel_wide_hops(wide, hop):
    p = _params("HIGHEST", wide)
    geo = p.geometry(p.clip_samples)
    geo.update(hop=hop, n_frames=1 + p.clip_samples // hop)
    frames, _ = ops.f32_device_plan(2, geo["n_frames"], hop, p.ksup, p.w_cos.shape[1], "cuda")
    assert frames == ops.f32_frames_per_block(hop, p.ksup) < 128
    _held_to_plain("logmel_f32", p, _wave(p, 2), geo)


@pytest.mark.parametrize("batch", [8, 128])
def test_f32_kernel_is_deterministic(batch):
    """The frequency slices are added in a fixed order, without atomics."""
    p = _params("HIGHEST")
    args, geo = (_wave(p, batch), p.w_cos, p.w_sin, p.mel_w), p.geometry(p.clip_samples)
    first = ops.logmel_f32(*args, **geo)
    assert torch.equal(first, ops.logmel_f32(*args, **geo))


def test_frames_per_block_halve_as_the_hop_widens():
    """Both kernels' blocks take 128 frames, halved while a wide hop's span
    overflows shared memory; the main paths' hop (120) keeps 128."""
    for frames_of in (ops.f32_frames_per_block, ops.tc_frames_per_block):
        for ksup in (256, 2048):
            got = [frames_of(hop, ksup) for hop in (120, 331, 700, 2001, 20000)]
            assert got[0] == 128 and got[-1] < got[1] <= 128, (frames_of.__name__, ksup, got)
            assert all(a >= b and b & (b - 1) == 0 for a, b in zip(got, got[1:]))


def test_prefetch_delivers_the_host_batches_while_the_consumer_is_busy():
    """Depth 2 over two epochs of 16 MB int16 batches. Each batch is cloned
    on the consumer's stream, after a long kernel on every other one: a
    missing stream wait reads a copy in flight, a missing ``record_stream``
    lets a later copy land in memory a queued clone still reads."""
    _prefetch_round_trip(depth=2)


def test_prefetch_without_a_worker_delivers_the_host_batches():
    """Depth 0 copies each batch on the same side stream when it is asked for."""
    _prefetch_round_trip(depth=0)


def _prefetch_round_trip(depth):
    rng = np.random.default_rng(9)
    host = [{"waveform": rng.integers(-2**15, 2**15, (256, 30695), dtype=np.int16),
             "n_valid": rng.integers(1, 30695, 256).astype(np.int32),
             "labels": {"class_id": rng.integers(0, 309, 256)}} for _ in range(6)]
    for _ in range(2):
        got = []
        with Prefetcher(host, "cuda", depth=depth) as src:
            for i, batch in enumerate(src):
                if i % 2:
                    torch.cuda._sleep(20_000_000)  # ~10 ms on the consumer's stream
                got.append({"waveform": batch["waveform"].clone(),
                            "n_valid": batch["n_valid"].clone(),
                            "class_id": batch["labels"]["class_id"].clone()})
                del batch
        torch.cuda.synchronize()
        assert len(got) == len(host)
        for g, h in zip(got, host):
            assert g["waveform"].dtype == torch.int16 and g["class_id"].dtype == torch.int64
            assert torch.equal(g["waveform"].cpu(), torch.from_numpy(h["waveform"]))
            assert torch.equal(g["n_valid"].cpu(), torch.from_numpy(h["n_valid"]))
            assert torch.equal(g["class_id"].cpu(), torch.from_numpy(h["labels"]["class_id"]))


def _tiny_vgg_cfg(tmp_path, precision, splits):
    """A tiny SlowFast at the flagship geometry, B = 4, on seeded 1.5 s int16
    wav files: ``splits`` maps each split to its clip count."""
    cfg = flagship_cfg()
    cfg.MODEL.NUM_CLASSES = [6]
    cfg.RESNET.DEPTH = 26
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.GPU.DSP_PRECISION = precision
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 4
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.LOG_MODEL_INFO = False
    rng = np.random.default_rng(4)
    for split, n in splits.items():
        rows = []
        for i in range(n):
            wave = (rng.standard_normal(36000) * 3000).astype(np.int16)  # 1.5 s
            wavfile.write(str(tmp_path / f"{split}{i}.wav"), 24000, wave)
            rows.append({"video": f"{split}{i}.mp4", "class_id": i % 6})
        with open(tmp_path / f"{split}.pkl", "wb") as f:
            pickle.dump(rows, f)
    cfg.VGGSOUND.AUDIO_DATA_DIR = cfg.VGGSOUND.ANNOTATIONS_DIR = str(tmp_path)
    cfg.VGGSOUND.TRAIN_LIST, cfg.VGGSOUND.VAL_LIST = "train.pkl", "val.pkl"
    cfg.VGGSOUND.TEST_LIST = "test.pkl"
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    return cfg


WRAPPERS = [ops.logmel_f32, ops.logmel_bf16, ops.logmel_bf16_wide]


def _launches():
    return {w.__name__: w.launches for w in WRAPPERS}


@pytest.mark.parametrize("precision,kernel", [("BFLOAT16", "logmel_bf16"),
                                              ("HIGHEST", "logmel_f32")])
def test_train_cfg_counts_its_launches(tmp_path, precision, kernel):
    """A tiny SlowFast at the flagship geometry, B = 4: 12 train clips (3
    steps), precise BN over 2 batches, 6 val clips (4 + 2): 7 launches."""
    cfg = _tiny_vgg_cfg(tmp_path, precision, {"train": 12, "val": 6})
    for w in WRAPPERS:
        w.launches = 0
    state = train(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (7 if w.__name__ == kernel else 0) for w in WRAPPERS}
    assert state.step == 3 and next(state.model.parameters()).is_cuda
    assert os.path.exists(tmp_path / "out" / "checkpoints" / "checkpoint_epoch_00001.pyth")


@pytest.mark.parametrize("precision,kernel", [("BFLOAT16", "logmel_bf16"),
                                              ("HIGHEST", "logmel_f32")])
def test_test_cfg_counts_its_launches(tmp_path, precision, kernel):
    """5 test clips in 2 views, B = 4 (4 + 4 + 2): 3 launches; every clip
    ensembles its 2 probability rows."""
    cfg = _tiny_vgg_cfg(tmp_path, precision, {"test": 5})
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    for w in WRAPPERS:
        w.launches = 0
    preds, labels = run_test(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (3 if w.__name__ == kernel else 0) for w in WRAPPERS}
    assert preds.shape == (5, 6) and np.isfinite(preds).all()
    np.testing.assert_allclose(preds.sum(axis=1), 2.0, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(labels, np.arange(5) % 6)
    with open(tmp_path / "out" / "scores" / "test_scores.pkl", "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["output"], preds)


def test_prefetch_from_worker_processes_delivers_the_host_batches(tmp_path):
    """Two epochs of the train split read by 2 worker processes and copied
    through the prefetcher, each batch cloned behind a long kernel on every
    other one, equal bit for bit to the batches read in this process."""
    cfg = _tiny_vgg_cfg(tmp_path, "BFLOAT16", {"train": 12})
    lds = {}
    for workers in (0, 2):
        cfg.DATA_LOADER.NUM_WORKERS = workers
        lds[workers] = construct_loader(cfg, "train")
    try:
        for epoch in (0, 1):
            for ld in lds.values():
                shuffle_dataset(ld, epoch)
            host = list(lds[0])
            got = []
            with prefetch(lds[2], "cuda") as src:
                for i, batch in enumerate(src):
                    if i % 2:
                        torch.cuda._sleep(20_000_000)  # ~10 ms on the consumer's stream
                    got.append({k: batch[k].clone() for k in ("waveform", "n_valid", "index")})
            torch.cuda.synchronize()
            assert len(got) == len(host) == 3
            for g, h in zip(got, host):
                assert g["waveform"].dtype == torch.int16 and g["waveform"].is_cuda
                for k in g:
                    assert torch.equal(g[k].cpu(), torch.from_numpy(h[k])), k
        assert len(lds[2].worker_pids()) == 2
    finally:
        for ld in lds.values():
            ld.close()
    assert lds[2].worker_pids() == []


def _tiny_epic_cfg(tmp_path, splits):
    """A tiny verb/noun SlowFast at the EPIC geometry (``epic_cfg``: 400
    frames, bf16 front end), B = 4, on two seeded 10 s int16 wav files:
    ``splits`` maps each split to its row count; a third of the rows are
    shorter than a clip and, in train, a quarter carry a transformation."""
    cfg = epic_cfg()
    cfg.MODEL.NUM_CLASSES = [6, 8]
    cfg.RESNET.DEPTH = 26
    cfg.RESNET.WIDTH_PER_GROUP = 8
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 4
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.BN.NUM_BATCHES_PRECISE = 2
    cfg.DATA_LOADER.NUM_WORKERS = 0
    cfg.LOG_MODEL_INFO = False
    rng = np.random.default_rng(4)
    for v in range(2):
        wave = (rng.standard_normal(240000) * 3000).astype(np.int16)
        wavfile.write(str(tmp_path / f"P01_{v:02d}.wav"), 24000, wave)
    for split, n in splits.items():
        rows = []
        for i in range(n):
            start, secs = 0.5 + 0.7 * i, (1.2 if i % 3 == 0 else 2.5)
            row = {"narration_id": f"{split}_{i}", "participant_id": "P01",
                   "video_id": f"P01_{i % 2:02d}", "start_timestamp": f"00:00:{start:05.2f}",
                   "stop_timestamp": f"00:00:{start + secs:05.2f}",
                   "verb_class": i % 6, "noun_class": i % 8}
            if split == "train" and i % 4 == 1:
                row["transformation"] = "gaussian_noise"
            rows.append(row)
        with open(tmp_path / f"{split}.pkl", "wb") as f:
            pickle.dump(rows, f)
    c = cfg.EPICKITCHENS
    c.AUDIO_DATA_FILE = c.ANNOTATIONS_DIR = str(tmp_path)
    c.PROCESSED_TRAIN_LIST, c.PROCESSED_VAL_LIST = "train.pkl", "val.pkl"
    c.PROCESSED_TEST_LIST = "test.pkl"
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    return cfg


def test_epic_train_cfg_counts_its_launches(tmp_path):
    """12 train rows (3 steps, float32: transformed rows), precise BN over 2
    batches, 6 val rows (4 + 2, int16): 7 launches of ``logmel_bf16``."""
    cfg = _tiny_epic_cfg(tmp_path, {"train": 12, "val": 6})
    for w in WRAPPERS:
        w.launches = 0
    state = train(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (7 if w.__name__ == "logmel_bf16" else 0)
                           for w in WRAPPERS}
    assert state.step == 3 and next(state.model.parameters()).is_cuda


def test_epic_test_cfg_counts_its_launches(tmp_path):
    """5 test rows in 2 views, B = 4 (4 + 4 + 2): 3 launches; the verb and
    noun scores of every clip ensemble its 2 probability rows, and the
    pickle carries the narration ids."""
    cfg = _tiny_epic_cfg(tmp_path, {"test": 5})
    for w in WRAPPERS:
        w.launches = 0
    (verb, noun), (verb_l, noun_l), ids = run_test(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (3 if w.__name__ == "logmel_bf16" else 0)
                           for w in WRAPPERS}
    assert verb.shape == (5, 6) and noun.shape == (5, 8)
    for scores in (verb, noun):
        np.testing.assert_allclose(scores.sum(axis=1), 2.0, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(noun_l, np.arange(5) % 8)
    with open(tmp_path / "out" / "scores" / "test_scores.pkl", "rb") as f:
        saved = pickle.load(f)
    assert list(saved["narration_id"]) == list(ids) == [f"test_{i}" for i in range(5)]


def _tiny_gru_cfg(tmp_path, splits):
    """``_tiny_epic_cfg`` read as chains: ``AudioSlowFastGRU`` with a GRU of
    H = 32, at most 4 windows (the 2.5 s rows give 2, the 1.2 s rows 1)."""
    cfg = _tiny_epic_cfg(tmp_path, splits)
    cfg.MODEL.MODEL_NAME = "AudioSlowFastGRU"
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchensGRU"
    cfg.MODEL.GRU_HIDDEN_SIZE = 32
    cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS = 4
    return cfg


def test_gru_train_cfg_counts_its_launches(tmp_path):
    """12 train chains (3 steps), precise BN over 2 batches, 6 val chains
    (4 + 2): one launch of ``logmel_bf16`` a batch, 7."""
    cfg = _tiny_gru_cfg(tmp_path, {"train": 12, "val": 6})
    for w in WRAPPERS:
        w.launches = 0
    state = train(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (7 if w.__name__ == "logmel_bf16" else 0)
                           for w in WRAPPERS}
    assert state.step == 3 and state.model.head.gru.weight_ih_l0.is_cuda


def test_gru_test_cfg_counts_its_launches(tmp_path):
    """5 test chains in one view each, B = 4 (4 + 1): 2 launches; each
    chain's verb and noun rows are one probability row."""
    cfg = _tiny_gru_cfg(tmp_path, {"test": 5})
    for w in WRAPPERS:
        w.launches = 0
    (verb, noun), _, ids = run_test(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (2 if w.__name__ == "logmel_bf16" else 0)
                           for w in WRAPPERS}
    assert verb.shape == (5, 6) and noun.shape == (5, 8)
    for scores in (verb, noun):
        np.testing.assert_allclose(scores.sum(axis=1), 1.0, rtol=0, atol=1e-4)
    assert list(ids) == [f"test_{i}" for i in range(5)]


@pytest.mark.parametrize("arch", ["slow", "fast"])
def test_resnet_train_and_test_cfg_count_their_launches(tmp_path, arch):
    """The tiny single-pathway ResNet at the flagship geometry, B = 4: 12
    train clips (3 steps), precise BN over 2 batches and 6 val clips (4 + 2)
    make 7 launches of ``logmel_bf16``; then 5 test clips in 2 views (4 + 4
    + 2) 3 more, each clip's 2 probability rows summed."""
    cfg = _tiny_vgg_cfg(tmp_path, "BFLOAT16", {"train": 12, "val": 6, "test": 5})
    cfg.MODEL.MODEL_NAME, cfg.MODEL.ARCH = "ResNet", arch
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 2
    for w in WRAPPERS:
        w.launches = 0
    state = train(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (7 if w.__name__ == "logmel_bf16" else 0)
                           for w in WRAPPERS}
    assert state.step == 3 and state.model.s1.pathway0_stem.conv.weight.is_cuda
    cfg.TEST.CHECKPOINT_FILE_PATH = str(tmp_path / "out" / "checkpoints"
                                        / "checkpoint_epoch_00001.pyth")
    preds, _ = run_test(cfg)
    torch.cuda.synchronize()
    assert _launches()["logmel_bf16"] == 10
    np.testing.assert_allclose(preds.sum(axis=1), 2.0, rtol=0, atol=1e-4)


def test_slide_test_cfg_counts_its_launches(tmp_path):
    """Whole-video windows of 1 s every 0.5 s over ``_tiny_epic_cfg``'s 2
    videos of 10 s (19 each), B = 16: 3 launches; the scored windows'
    verb rows are probability rows and their labels (4,) rows."""
    cfg = _tiny_epic_cfg(tmp_path, {"test": 5})
    (tmp_path / "EPIC_100_video_info.csv").write_text("video_id,duration\nP01_00,10\nP01_01,10\n")
    cfg.TEST.DATASET = "EpicKitchensSlide"
    cfg.TEST.BATCH_SIZE = 16
    s = cfg.TEST.SLIDE
    s.ENABLE, s.WIN_SIZE, s.HOP_SIZE = True, 1.0, 0.5
    s.INSIDE_ACTION_BOUNDS = s.PER_ACTION_INSTANCE = False
    for w in WRAPPERS:
        w.launches = 0
    (verb, _), (verb_l, _), ids = run_test(cfg)
    torch.cuda.synchronize()
    assert _launches() == {w.__name__: (3 if w.__name__ == "logmel_bf16" else 0)
                           for w in WRAPPERS}
    assert 0 < verb.shape[0] <= 38 and verb_l.shape == (verb.shape[0], 4)
    np.testing.assert_allclose(verb.sum(axis=1), 1.0, rtol=0, atol=1e-4)
    assert set(ids) <= {"0", "1"}


def test_the_tensor_parallel_functions_on_the_card(tmp_path):
    """The two autograd Functions of ``parallel/tensor.py`` at a 1 x 2 grid
    of gloo ranks on ``cuda:0``: a sharded conv, grouped conv and linear in
    float64, forward and backward, against the unsharded layers on the card
    (1e-12): the outputs and input gradients whole, each parameter's
    gradient its rank's block."""
    import functools

    import torch.multiprocessing as mp

    from asf_tpu_torch.config import get_cfg
    from asf_tpu_torch.tools import run_net
    from torch_dist_ranks import free_port, tp_forward, tp_functions_rank, tp_layers

    cfg = get_cfg()
    cfg.GPU.MODEL_PARALLEL = 2
    body = functools.partial(tp_functions_rank, out=str(tmp_path))
    mp.spawn(run_net.run_rank, args=(cfg, f"tcp://localhost:{free_port()}", body, "cuda:0",
                                     "gloo"), nprocs=2, join=True)
    want = tp_forward(tp_layers("cuda"), "cuda")
    for r in range(2):
        got = torch.load(tmp_path / f"tp_rank{r}.pt")
        assert got["names"] == ["conv.weight", "grouped.weight", "linear.weight"]
        for k, w in want.items():
            if k.startswith("d_"):  # every layer is sharded: its parameters' blocks
                n = w.shape[0] // 2
                w = w[r * n:(r + 1) * n]
            assert got[k].shape == w.shape, k
            assert (got[k] - w).abs().max().item() <= 1e-12 * max(1.0, w.abs().max().item()), k
