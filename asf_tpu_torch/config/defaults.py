"""Default config tree of the PyTorch port.

The nodes the eval and train slices, the VGG-Sound and EPIC-KITCHENS data
paths, ``train(cfg)`` and ``test(cfg)`` read, copied key-for-key from
``asf_tpu/config/defaults.py`` so that YAMLs written for the JAX package
merge unchanged, plus a ``GPU`` node: the counterparts of
``TPU.COMPUTE_DTYPE``, ``TPU.DSP_PRECISION``, ``TPU.SPEC_AUGMENT``,
``TPU.INT16_TRANSFER``, ``TPU.WATCH_HISTOGRAMS`` and ``TPU.PROFILE_*``. There is no kernel
on/off switch: on CUDA tensors the hand-written kernels always run, on CPU tensors
their plain PyTorch versions do.
"""

from .cfg_node import CfgNode

_C = CfgNode()

# ---------------------------------------------------------------------------
# Batch norm options
# ---------------------------------------------------------------------------
_C.BN = CfgNode()
_C.BN.FREEZE = False
_C.BN.USE_PRECISE_STATS = False
_C.BN.NUM_BATCHES_PRECISE = 200
_C.BN.WEIGHT_DECAY = 0.0
# `batchnorm`, `sub_batchnorm` (NUM_SPLITS splits of the global batch) or
# `sync_batchnorm` (groups of NUM_SYNC_DEVICES ranks): models/norm.py.
_C.BN.NORM_TYPE = "batchnorm"
_C.BN.NUM_SPLITS = 1
_C.BN.NUM_SYNC_DEVICES = 1

# ---------------------------------------------------------------------------
# Training options
# ---------------------------------------------------------------------------
_C.TRAIN = CfgNode()
_C.TRAIN.ENABLE = True
_C.TRAIN.DATASET = "vggsound"
_C.TRAIN.BATCH_SIZE = 64
_C.TRAIN.EVAL_PERIOD = 10
_C.TRAIN.CHECKPOINT_PERIOD = 10
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.CHECKPOINT_FILE_PATH = ""
_C.TRAIN.CHECKPOINT_EPOCH_RESET = False
_C.TRAIN.CHECKPOINT_CLEAR_NAME_PATTERN = ()

# ---------------------------------------------------------------------------
# Testing options
# ---------------------------------------------------------------------------
_C.TEST = CfgNode()
_C.TEST.ENABLE = True
_C.TEST.DATASET = "vggsound"
_C.TEST.BATCH_SIZE = 8
_C.TEST.CHECKPOINT_FILE_PATH = ""
_C.TEST.NUM_ENSEMBLE_VIEWS = 10
# The score pickle's name under OUTPUT_DIR/scores ("" is test_scores.pkl).
_C.TEST.SAVE_RESULTS_PATH = ""

# Sliding-window testing over untrimmed EPIC videos (EpicKitchensSlide):
# windows of WIN_SIZE s every HOP_SIZE s over each whole video, or inside
# each action (INSIDE_ACTION_BOUNDS), or one window an action
# (PER_ACTION_INSTANCE). LABEL_FRAME is read by neither package; it is kept
# so that the repo's slide YAMLs merge.
_C.TEST.SLIDE = CfgNode()
_C.TEST.SLIDE.ENABLE = False
_C.TEST.SLIDE.WIN_SIZE = 1.0
_C.TEST.SLIDE.HOP_SIZE = 1.0
_C.TEST.SLIDE.LABEL_FRAME = 0.5
_C.TEST.SLIDE.INSIDE_ACTION_BOUNDS = True
_C.TEST.SLIDE.PER_ACTION_INSTANCE = True

# ---------------------------------------------------------------------------
# ResNet options
# ---------------------------------------------------------------------------
_C.RESNET = CfgNode()
_C.RESNET.TRANS_FUNC = "bottleneck_transform"
_C.RESNET.NUM_GROUPS = 1
_C.RESNET.WIDTH_PER_GROUP = 64
_C.RESNET.INPLACE_RELU = True
_C.RESNET.STRIDE_1X1 = False
_C.RESNET.ZERO_INIT_FINAL_BN = False
_C.RESNET.DEPTH = 50
_C.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3], [4], [6], [3]]
_C.RESNET.FREQUENCY_STRIDES = [[1], [2], [2], [2]]
_C.RESNET.FREQUENCY_DILATIONS = [[1], [1], [1], [1]]

# ---------------------------------------------------------------------------
# Model options
# ---------------------------------------------------------------------------
_C.MODEL = CfgNode()
_C.MODEL.ARCH = "slowfast"
_C.MODEL.CLIP_MODEL = "ViT-B/32"
_C.MODEL.MODEL_NAME = "SlowFast"
_C.MODEL.NUM_CLASSES = [400]
_C.MODEL.GRU_HIDDEN_SIZE = 512
_C.MODEL.GRU_NUM_LAYERS = 2
_C.MODEL.VOCAB_FILE = ""
_C.MODEL.ONLY_ACTION_RECOGNITION = False
_C.MODEL.LOSS_FUNC = "cross_entropy"
_C.MODEL.STATE_LOSS_FUNC = "masked_loss"
_C.MODEL.SINGLE_PATHWAY_ARCH = ["slow", "fast"]
_C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast"]
_C.MODEL.DROPOUT_RATE = 0.5
_C.MODEL.DROPCONNECT_RATE = 0.0
_C.MODEL.FC_INIT_STD = 0.01
_C.MODEL.HEAD_ACT = "softmax"
# Only values ending in ".csv" activate the state-class append
# (models/builders._maybe_append_state_classes).
_C.MODEL.PDDL_ATTRIBUTES = "softmax"

# ---------------------------------------------------------------------------
# SlowFast options
# ---------------------------------------------------------------------------
_C.SLOWFAST = CfgNode()
_C.SLOWFAST.BETA_INV = 8
_C.SLOWFAST.ALPHA = 8
_C.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
_C.SLOWFAST.FUSION_KERNEL_SZ = 5

# ---------------------------------------------------------------------------
# Data options
# ---------------------------------------------------------------------------
_C.DATA = CfgNode()
_C.DATA.INPUT_CHANNEL_NUM = [1, 1]
_C.DATA.MULTI_LABEL = False
_C.DATA.ENSEMBLE_METHOD = "sum"
_C.DATA.ONLY_SYMBOLIC_STATE = False

# ---------------------------------------------------------------------------
# Audio data options
# ---------------------------------------------------------------------------
_C.AUDIO_DATA = CfgNode()
_C.AUDIO_DATA.SAMPLING_RATE = 24000
_C.AUDIO_DATA.N_FFT = 2048
_C.AUDIO_DATA.CLIP_SECS = 1.279
_C.AUDIO_DATA.WINDOW_LENGTH = 10.0
_C.AUDIO_DATA.HOP_LENGTH = 5.0
_C.AUDIO_DATA.NUM_FRAMES = 256
_C.AUDIO_DATA.NUM_FREQUENCIES = 128
_C.AUDIO_DATA.SPECTROGRAM_OVERLAP = 1.0
_C.AUDIO_DATA.MAX_NB_SPECTROGRAMS = 15

# ---------------------------------------------------------------------------
# VGG-Sound dataset options
# ---------------------------------------------------------------------------
_C.VGGSOUND = CfgNode()
_C.VGGSOUND.AUDIO_DATA_DIR = ""
_C.VGGSOUND.ANNOTATIONS_DIR = ""
_C.VGGSOUND.TRAIN_LIST = "train.pkl"
_C.VGGSOUND.VAL_LIST = "test.pkl"
_C.VGGSOUND.TEST_LIST = "test.pkl"

# ---------------------------------------------------------------------------
# EPIC-KITCHENS dataset options
# ---------------------------------------------------------------------------
_C.EPICKITCHENS = CfgNode()
# The port reads a directory of per-video mono wav files, <video_id>.wav
# (data/epickitchens.py); the JAX package reads one HDF5 file.
_C.EPICKITCHENS.AUDIO_DATA_FILE = ""
_C.EPICKITCHENS.ANNOTATIONS_DIR = ""
_C.EPICKITCHENS.ORIGINAL_TRAIN_LIST = "EPIC_100_train.pkl"
_C.EPICKITCHENS.PROCESSED_TRAIN_LIST = "EPIC_100_train.pkl"
_C.EPICKITCHENS.ORIGINAL_VAL_LIST = "EPIC_100_validation.pkl"
_C.EPICKITCHENS.PROCESSED_VAL_LIST = "EPIC_100_validation.pkl"
_C.EPICKITCHENS.ORIGINAL_TEST_LIST = "EPIC_100_validation.pkl"
_C.EPICKITCHENS.PROCESSED_TEST_LIST = "EPIC_100_validation.pkl"
_C.EPICKITCHENS.TRAIN_PLUS_VAL = False
_C.EPICKITCHENS.TEST_SPLIT = "validation"
_C.EPICKITCHENS.VERBS_FILE = ""
_C.EPICKITCHENS.NOUNS_FILE = ""
_C.EPICKITCHENS.MAKE_PLOTS = False
_C.EPICKITCHENS.SKIP_PREPARATION = False
_C.EPICKITCHENS.VERBS = []
_C.EPICKITCHENS.ALL_VERBS = False
_C.EPICKITCHENS.SMALL = False
_C.EPICKITCHENS.SINGLE_BATCH = False

_C.EPICKITCHENS.STATE = CfgNode()
_C.EPICKITCHENS.STATE.PDDL_DOMAIN = ""
_C.EPICKITCHENS.STATE.PDDL_PROBLEM = ""
_C.EPICKITCHENS.PDDL_DOMAIN = ""
_C.EPICKITCHENS.PDDL_PROBLEM = ""
_C.EPICKITCHENS.STATE.NOUNS_EMBEDDINGS_FILE = ""

_C.EPICKITCHENS.AUGMENT = CfgNode()
_C.EPICKITCHENS.AUGMENT.BALANCE = True
_C.EPICKITCHENS.AUGMENT.ENABLE = False
_C.EPICKITCHENS.AUGMENT.FACTOR = 1.0

_C.EPICKITCHENS.VIDEO_DURS = "EPIC_100_video_info.csv"

# ---------------------------------------------------------------------------
# Data loader options
# ---------------------------------------------------------------------------
_C.DATA_LOADER = CfgNode()
_C.DATA_LOADER.NUM_WORKERS = 8
# Taken from the repo's YAMLs and not read: the prefetcher always pins.
_C.DATA_LOADER.PIN_MEMORY = True

# ---------------------------------------------------------------------------
# Optimizer options
# ---------------------------------------------------------------------------
_C.SOLVER = CfgNode()
_C.SOLVER.BASE_LR = 0.1
_C.SOLVER.LR_POLICY = "cosine"
_C.SOLVER.COSINE_END_LR = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEP_SIZE = 1
_C.SOLVER.STEPS = []
_C.SOLVER.LRS = []
_C.SOLVER.MAX_EPOCH = 300
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.DAMPENING = 0.0
_C.SOLVER.NESTEROV = True
_C.SOLVER.WEIGHT_DECAY = 1e-4
_C.SOLVER.WARMUP_FACTOR = 0.1
_C.SOLVER.WARMUP_EPOCHS = 0.0
_C.SOLVER.WARMUP_START_LR = 0.01
_C.SOLVER.OPTIMIZING_METHOD = "sgd"
_C.SOLVER.BASE_LR_SCALE_NUM_SHARDS = False

# ---------------------------------------------------------------------------
# Misc options
# ---------------------------------------------------------------------------
_C.NUM_SHARDS = 1
_C.SHARD_ID = 0
# Ranks a host (one process a device, started by tools/run_net.py);
# TRAIN.BATCH_SIZE and TEST.BATCH_SIZE are a host's and split over them.
_C.NUM_GPUS = 1
_C.OUTPUT_DIR = "./tmp"
_C.RNG_SEED = 1
_C.LOG_PERIOD = 10
_C.LOG_MODEL_INFO = True

# ---------------------------------------------------------------------------
# Observers (engine/observers.py): TensorBoard scalars and val plots, W&B
# scalars, histograms and alerts. Each sink is imported where it is used;
# without its package it warns and training goes on.
# ---------------------------------------------------------------------------
_C.TENSORBOARD = CfgNode()
_C.TENSORBOARD.ENABLE = False
_C.TENSORBOARD.PREDICTIONS_PATH = ""
_C.TENSORBOARD.LOG_DIR = ""
_C.TENSORBOARD.CLASS_NAMES_PATH = ""
_C.TENSORBOARD.CATEGORIES_PATH = ""

_C.TENSORBOARD.CONFUSION_MATRIX = CfgNode()
_C.TENSORBOARD.CONFUSION_MATRIX.ENABLE = False
_C.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE = [8, 8]
_C.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = ""

_C.TENSORBOARD.HISTOGRAM = CfgNode()
_C.TENSORBOARD.HISTOGRAM.ENABLE = False
_C.TENSORBOARD.HISTOGRAM.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM.TOPK = 10
_C.TENSORBOARD.HISTOGRAM.FIGSIZE = [8, 8]

_C.WANDB = CfgNode()
_C.WANDB.ENABLE = False
# A run id resumes that W&B run (resume="must").
_C.WANDB.RUN_ID = ""

# ---------------------------------------------------------------------------
# GPU options of the port (counterparts of the JAX package's TPU node)
# ---------------------------------------------------------------------------
_C.GPU = CfgNode()
# Compute dtype of the conv trunk ("bfloat16" or "float32"). Parameters and
# BN statistics stay float32.
_C.GPU.COMPUTE_DTYPE = "bfloat16"
# Log-mel front end: "HIGHEST" runs the float32 kernel (librosa parity),
# "BFLOAT16" the bf16-input kernel with float32 accumulation.
_C.GPU.DSP_PRECISION = "HIGHEST"
# SpecAugment (time warp, 2 frequency and 2 time masks) on every training
# spectrogram, as the reference does; False takes it out of the train step.
_C.GPU.SPEC_AUGMENT = True
# Ship 16-bit-PCM waveforms to the card as raw int16; the input pipeline
# applies the /32768 scale (bit-identical to the host conversion) and the
# copy moves half the bytes. Applies to wav-backed datasets.
_C.GPU.INT16_TRANSFER = True
# Per-layer parameter and gradient histograms (64 bins and the range of each
# leaf, counted on the card) every LOG_PERIOD steps, sent to W&B when
# WANDB.ENABLE and a W&B run is live; skipped otherwise.
_C.GPU.WATCH_HISTOGRAMS = True
# When non-empty, a torch.profiler trace (CPU and CUDA activities, a Chrome
# trace file) of PROFILE_NUM_ITERS training steps from PROFILE_START_ITER of
# the first epoch is written into this directory.
_C.GPU.PROFILE_DIR = ""
_C.GPU.PROFILE_START_ITER = 10
_C.GPU.PROFILE_NUM_ITERS = 5


def _assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """The checks of ``asf_tpu``'s ``_assert_and_infer_cfg`` on the nodes kept."""
    if cfg.BN.USE_PRECISE_STATS:
        assert cfg.BN.NUM_BATCHES_PRECISE >= 0
    assert cfg.TRAIN.BATCH_SIZE % max(1, cfg.NUM_GPUS) == 0
    assert cfg.TEST.BATCH_SIZE % max(1, cfg.NUM_GPUS) == 0
    assert cfg.RESNET.NUM_GROUPS > 0
    assert cfg.RESNET.WIDTH_PER_GROUP > 0
    assert cfg.RESNET.WIDTH_PER_GROUP % cfg.RESNET.NUM_GROUPS == 0
    if cfg.SOLVER.BASE_LR_SCALE_NUM_SHARDS:
        cfg.SOLVER.BASE_LR *= cfg.NUM_SHARDS
    assert cfg.SHARD_ID < cfg.NUM_SHARDS
    return cfg


def get_cfg() -> CfgNode:
    """Get a validated copy of the default config."""
    return _assert_and_infer_cfg(_C.clone())
