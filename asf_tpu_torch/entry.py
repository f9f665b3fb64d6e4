"""Entry points of the port: the flagship eval forward and train step, and
the configurations of the flagship, of the single-pathway Slow-only and
Fast-only ResNet, of EPIC-KITCHENS verb/noun and its sliding-window
testing, of the EPIC-KITCHENS GRU sequence model and of their state heads.

``entry`` is the counterpart of ``__graft_entry__.py:17-65``: the VGG-Sound
``AudioSlowFast`` (SlowFast-R50, 309 classes, bf16 trunk) behind the log-mel
front end, in eval mode (softmax, then the mean over positions).
``train_entry`` is the counterpart of ``scripts/bench_train.py:20-55`` and
``__graft_entry__.py:_run_variant`` (:144-157): the same model's train step,
waveform -> loss -> gradients -> SGD update, with SpecAugment on.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import get_cfg
from .engine.pipeline import make_input_pipeline
from .engine.steps import init_state, make_train_step
from .models import build_model
from .utils.torch_setup import disable_tf32, resolve_device


def flagship_cfg():
    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "AudioSlowFast"
    cfg.MODEL.ARCH = "slowfast"
    cfg.MODEL.NUM_CLASSES = [309]  # VGG-Sound
    cfg.RESNET.DEPTH = 50
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3, 3], [4, 4], [6, 6], [3, 3]]
    cfg.RESNET.FREQUENCY_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.FREQUENCY_DILATIONS = [[1, 1], [1, 1], [1, 1], [1, 1]]
    cfg.GPU.COMPUTE_DTYPE = "bfloat16"
    return cfg


# Classes of the released checkpoints' heads: EPIC-KITCHENS-100 verbs and
# nouns, VGG-Sound's one head.
RELEASE_CLASSES = {"epic": [97, 300], "vgg": [309]}


def resnet_cfg(arch: str = "slow", dataset: str = "vgg"):
    """The single-pathway ResNet of the released Slow-only and Fast-only
    checkpoints, the port's copy of ``scripts/verify_release_ckpt.py:50-76``
    (``build_cfg``): ``MODEL_NAME`` "ResNet" with ``MODEL.ARCH`` ``arch``
    ("slow" or "fast"), R50 (``WIDTH_PER_GROUP`` 64) with the flagship's
    stage lists, the classes of ``dataset`` ("vgg": 309; "epic": 97 verbs
    and 300 nouns), the default geometry (256 frames, 128 mels), and the
    bf16 trunk. ``build_cfg`` computes in float32 to check a released
    checkpoint; ``entry``'s float32 front end serves that check.
    ``MODEL.ONLY_ACTION_RECOGNITION`` is on: the ResNet has no state head,
    and the loss of a verb/noun config with it off would ask for state
    labels. The data keys (``VGGSOUND.*``, or ``TRAIN.DATASET`` and
    ``EPICKITCHENS.*`` as in ``epic_cfg``) are the caller's.
    """
    if arch not in ("slow", "fast") or dataset not in RELEASE_CLASSES:
        raise ValueError(f"resnet_cfg takes arch 'slow' or 'fast' and dataset "
                         f"{sorted(RELEASE_CLASSES)}, not {arch!r}, {dataset!r}")
    cfg = flagship_cfg()
    cfg.MODEL.MODEL_NAME = "ResNet"
    cfg.MODEL.ARCH = arch
    cfg.MODEL.NUM_CLASSES = list(RELEASE_CLASSES[dataset])
    cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    return cfg


def epic_cfg():
    """The EPIC-KITCHENS-100 verb/noun configuration: the flagship trunk with
    the values of ``models/asf/config/asf-original-augment.yaml`` for the
    heads (97 verbs, 300 nouns), the clip (1.999 s, 400 frames), the data
    (``EpicKitchens``, B = 32, 10 test views, 8 loader workers), BN (frozen,
    precise statistics over up to 200 batches) and the solver (steps with
    relative LRs from 0.001, 30 epochs), fine-tuned from a VGG-Sound
    checkpoint (``TRAIN.CHECKPOINT_EPOCH_RESET``), with the bf16 front end.

    The YAML's trunk differs from the flagship's in ``SLOWFAST.ALPHA`` (4),
    ``SLOWFAST.FUSION_KERNEL_SZ`` (7) and ``RESNET.ZERO_INIT_FINAL_BN``;
    these stay the flagship's, so that a checkpoint trained by
    ``flagship_cfg()`` gives every trunk leaf. The data paths
    (``EPICKITCHENS.*``, ``TRAIN.CHECKPOINT_FILE_PATH``) are the caller's.
    """
    cfg = flagship_cfg()
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchens"
    cfg.MODEL.NUM_CLASSES = [97, 300]
    cfg.MODEL.ONLY_ACTION_RECOGNITION = True
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.AUDIO_DATA.CLIP_SECS = 1.999
    cfg.AUDIO_DATA.NUM_FRAMES = 400
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 32
    cfg.TRAIN.EVAL_PERIOD = cfg.TRAIN.CHECKPOINT_PERIOD = 1
    cfg.TRAIN.CHECKPOINT_EPOCH_RESET = True
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 10
    cfg.BN.FREEZE = True
    cfg.BN.USE_PRECISE_STATS = True
    cfg.BN.NUM_BATCHES_PRECISE = 200
    cfg.SOLVER.BASE_LR = 0.001
    cfg.SOLVER.LR_POLICY = "steps_with_relative_lrs"
    cfg.SOLVER.STEPS = [0, 20, 25]
    cfg.SOLVER.LRS = [1, 0.1, 0.01]
    cfg.SOLVER.MAX_EPOCH = 30
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.SOLVER.WARMUP_EPOCHS = -1.0
    cfg.SOLVER.WARMUP_START_LR = 0.01
    cfg.DATA_LOADER.NUM_WORKERS = 8
    cfg.GPU.DSP_PRECISION = "BFLOAT16"
    cfg.RNG_SEED = 0
    return cfg


# TEST.SLIDE of the repo's slide YAMLs (models/asf/config/slide/): WIN_SIZE,
# HOP_SIZE, INSIDE_ACTION_BOUNDS, PER_ACTION_INSTANCE.
SLIDE_MODES = {
    "whole_video": (1.0, 0.5, False, False),  # asf-original-whole-video-1s.yaml
    "action_bounds": (2.0, 0.5, True, False),  # asf-original-action-bounds.yaml
    "per_instance": (2.0, 0.5, True, True),  # asf-original-per-instance.yaml
}


def epic_slide_cfg(mode: str = "whole_video"):
    """Sliding-window testing over untrimmed EPIC-KITCHENS-100 videos:
    ``epic_cfg()`` testing ``EpicKitchensSlide`` at B = 128 in one view with
    the ``TEST.SLIDE`` values of the repo's YAML of ``mode`` (``SLIDE_MODES``:
    windows of 1 s every 0.5 s over each whole video, windows of 2 s every
    0.5 s inside each action, or one window an action), ``TRAIN.ENABLE``
    off: the configuration only tests. The trunk is ``epic_cfg``'s, so that
    a checkpoint of ``epic_cfg()`` loads whole. The data paths
    (``EPICKITCHENS.*``, among them ``VIDEO_DURS`` for the whole-video mode)
    and ``TEST.CHECKPOINT_FILE_PATH`` are the caller's.
    """
    cfg = epic_cfg()
    cfg.TRAIN.ENABLE = False
    cfg.TEST.DATASET = "EpicKitchensSlide"
    cfg.TEST.BATCH_SIZE = 128
    cfg.TEST.NUM_ENSEMBLE_VIEWS = 1
    s = cfg.TEST.SLIDE
    s.ENABLE = True
    s.WIN_SIZE, s.HOP_SIZE, s.INSIDE_ACTION_BOUNDS, s.PER_ACTION_INSTANCE = SLIDE_MODES[mode]
    return cfg


def epic_gru_cfg():
    """The GRU sequence model, ``models/asf/config/asf-gru.yaml``, on the
    flagship trunk: ``AudioSlowFastGRU`` on ``EpicKitchensGRU`` chains of up
    to ``MAX_NB_SPECTROGRAMS`` = 20 windows of 1.999 s (400 frames, 1 s of
    overlap), B = 16 chains, a 2-layer bidirectional GRU with H = 512,
    dropout 0.5, 97 verbs and 300 nouns, action only; BN frozen with precise
    statistics over up to 64 batches; the YAML's solver (steps with relative
    LRs from 0.01, 20 epochs) and seed; fine-tuned from an EPIC verb/noun
    checkpoint (``TRAIN.CHECKPOINT_EPOCH_RESET``); the bf16 front end.

    The trunk follows ``epic_cfg``'s rule (the YAML's ``SLOWFAST.ALPHA``,
    ``FUSION_KERNEL_SZ`` and ``ZERO_INIT_FINAL_BN`` are not taken), so that a
    checkpoint of ``epic_cfg()`` gives every trunk leaf and both
    projections; the GRU and ``projection_to_dim_in`` start from their
    initialisation. The data paths are the caller's.
    """
    cfg = epic_cfg()
    cfg.MODEL.MODEL_NAME = "AudioSlowFastGRU"
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchensGRU"
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 16
    cfg.AUDIO_DATA.MAX_NB_SPECTROGRAMS = 20
    cfg.AUDIO_DATA.SPECTROGRAM_OVERLAP = 1.0
    cfg.MODEL.GRU_HIDDEN_SIZE = 512
    cfg.MODEL.GRU_NUM_LAYERS = 2
    cfg.BN.NUM_BATCHES_PRECISE = 64
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.STEPS = [0, 15, 17]
    cfg.SOLVER.MAX_EPOCH = 20
    cfg.RNG_SEED = 25
    return cfg


def epic_state_cfg():
    """The single-clip state head, ``models/asf/config/asf-state.yaml``, on
    the flagship trunk: ``epic_cfg()`` with ``MODEL.ONLY_ACTION_RECOGNITION``
    off (the heads ``[97, 300]`` and a third class appended by
    ``build_model``, the attributes of ``MODEL.PDDL_ATTRIBUTES``) on
    ``EpicKitchensWithPDDL`` rows (``precs_vec``, ``posts_vec``), B = 128,
    precise BN over up to 64 batches, fine-tuned from an EPIC verb/noun
    checkpoint.

    The YAML's ``EPICKITCHENS.SINGLE_BATCH`` (keep the first batch of each
    list, a debugging switch) and its 4 loader workers are not taken; the
    trunk follows ``epic_cfg``'s rule. ``MODEL.PDDL_ATTRIBUTES`` (a csv with
    an ``attribute`` column) and the data paths are the caller's.
    """
    cfg = epic_cfg()
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchensWithPDDL"
    cfg.MODEL.ONLY_ACTION_RECOGNITION = False
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 128
    cfg.BN.NUM_BATCHES_PRECISE = 64
    return cfg


def epic_gru_state_cfg():
    """The GRU state head, ``models/asf/config/asf-gru-state.yaml``:
    ``epic_gru_cfg()`` with ``MODEL.ONLY_ACTION_RECOGNITION`` off on
    ``EpicKitchensGRUwithPDDL`` chains (B = 16, seed 25): the three state
    projections over each window and the chain's 512-wide CLIP noun
    embedding as the GRU's h0 (so H = 512). ``MODEL.PDDL_ATTRIBUTES`` and
    the data paths are the caller's.
    """
    cfg = epic_gru_cfg()
    cfg.TRAIN.DATASET = cfg.TEST.DATASET = "EpicKitchensGRUwithPDDL"
    cfg.MODEL.ONLY_ACTION_RECOGNITION = False
    return cfg


def wide_window(cfg):
    """Sets the wide-window geometry on ``cfg`` and returns it.

    ``win_length = n_fft`` (librosa's default) with an effective hop of 120
    samples through the reference's ``hop = win - hop`` rule. At the
    flagship's 24 kHz and n_fft 2048 the aligned support is 2048 taps and the
    bf16 front end takes K3's kernel; every other shape stays as it is.
    """
    sr_khz = cfg.AUDIO_DATA.SAMPLING_RATE / 1e3
    n_fft = cfg.AUDIO_DATA.N_FFT
    cfg.AUDIO_DATA.WINDOW_LENGTH = n_fft / sr_khz
    cfg.AUDIO_DATA.HOP_LENGTH = (n_fft - 120) / sr_khz
    return cfg


def clip_samples(cfg) -> int:
    """Samples in one clip: the upstream loader slices clip_size - 1."""
    return int(round(cfg.AUDIO_DATA.SAMPLING_RATE * cfg.AUDIO_DATA.CLIP_SECS)) - 1


def entry(batch: int = 8, dsp_precision: str = "HIGHEST", device=None, cfg=None):
    """Returns ``(fn, (model, wave, n_valid))`` with ``fn(model, wave, n_valid) -> probs``.

    ``model`` is the model of ``cfg`` (default: ``flagship_cfg()``, the
    ``AudioSlowFast``) in eval mode, with weights drawn from ``torch.Generator().manual_seed(0)``
    (other weights: ``model.load_state_dict``);
    ``wave`` is a (batch, clip_samples) float32 example and ``n_valid`` its
    (batch,) record lengths. ``fn`` also takes int16 waveforms; its input
    pipeline is ``fn.pipeline``. Runs on the
    current CUDA device unless ``device="cpu"``; raises when CUDA is absent
    and no device was given.
    """
    device = resolve_device(device)
    disable_tf32()
    cfg = (cfg if cfg is not None else flagship_cfg()).clone()
    cfg.GPU.DSP_PRECISION = dsp_precision
    model = build_model(cfg, device, torch.Generator().manual_seed(0)).eval()
    pipeline = make_input_pipeline(cfg, device)

    s = clip_samples(cfg)
    wave = np.random.default_rng(0).standard_normal((batch, s)).astype(np.float32) * 0.1
    wave = torch.from_numpy(wave).to(device)
    n_valid = torch.full((batch,), s, dtype=torch.int32, device=device)

    @torch.inference_mode()
    def fn(model, wave, n_valid):
        return model(pipeline(wave, n_valid))

    fn.pipeline = pipeline
    return fn, (model, wave, n_valid)


def train_entry(batch: int = 64, dsp_precision: str = "BFLOAT16", device=None, cfg=None):
    """Returns ``(step, (state, example))`` with ``step(state, example, lr) -> (parts, stats)``.

    ``state`` holds the model of ``cfg`` (default: ``flagship_cfg()``, the
    ``AudioSlowFast``; ``TRAIN.BATCH_SIZE = batch``) with weights drawn from
    ``torch.Generator().manual_seed(0)``, its optimizer (nesterov SGD by
    default) and a SpecAugment generator seeded with 0. ``example`` is a
    seeded batch: ``waveform`` (batch, clip_samples) float32, ``n_valid`` and
    ``labels["class_id"]``. The step updates ``state`` in place; the LR comes
    from the caller (``utils/lr_policy.get_lr_at_epoch``). Runs on the
    current CUDA device unless ``device="cpu"``; raises when CUDA is absent
    and no device was given.
    """
    device = resolve_device(device)
    disable_tf32()
    cfg = (cfg if cfg is not None else flagship_cfg()).clone()
    cfg.GPU.DSP_PRECISION = dsp_precision
    cfg.TRAIN.BATCH_SIZE = batch
    model = build_model(cfg, device, torch.Generator().manual_seed(0))
    state = init_state(cfg, model)
    step = make_train_step(cfg, device)

    s = clip_samples(cfg)
    rng = np.random.default_rng(0)
    example = {
        "waveform": torch.from_numpy(
            rng.standard_normal((batch, s)).astype(np.float32) * 0.1).to(device),
        "n_valid": torch.full((batch,), s, dtype=torch.int32, device=device),
        "labels": {"class_id": torch.from_numpy(
            rng.integers(0, cfg.MODEL.NUM_CLASSES[0], batch)).to(device)},
    }
    return step, (state, example)
