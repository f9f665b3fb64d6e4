"""Run a checkpoint on one whole audio file.

    python -m asf_tpu_torch.tools.predict path/to/audio.wav --cfg cfg.yaml \\
        [--device cpu] TEST.CHECKPOINT_FILE_PATH checkpoints/SLOWFAST_EPIC.pyth

Counterpart of ``asf_tpu/tools/predict.py``: the wav file is decoded
(``data/vggsound.py:load_wav``, channels averaged), resampled linearly to
``AUDIO_DATA.SAMPLING_RATE``, and its log-mel spectrogram computed in one
launch of the front end's kernel over the whole file, at ``max(NUM_FRAMES,
1 + samples // hop)`` frames (rounded down to a multiple of
``SLOWFAST.ALPHA`` for a two-pathway arch; frames past a file shorter than
a clip repeat its last one). The pathways go through the eval forward of
the model loaded with the test checkpoint's precedence
(``checkpoint/manager.py:load_test_checkpoint``); a GRU model is refused.

The scores are always written, to ``OUTPUT_DIR/predict_scores.npz`` (one
array a head: ``verb`` and ``noun``, or ``class``), and each head's top-1
class id is logged. ``OUTPUT_DIR/predict_scores.png``, the score
heatmaps, is drawn only where matplotlib imports; without it a warning
(the JAX package's predict needs matplotlib). Runs on the current CUDA
device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from ..utils.logging import get_logger, setup_logging

logger = get_logger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Run a trained model on one audio file.")
    parser.add_argument("path", help="The audio file (wav)")
    parser.add_argument("--cfg", dest="cfg_file", default=None, help="Config yaml")
    parser.add_argument(
        "--labels-dir",
        default="data/epic-kitchens-100-annotations",
        help="Directory with EPIC_100_{verb,noun}_classes.csv (optional)",
    )
    parser.add_argument("--device", default=None,
                        help="Device to run on: the current CUDA device unless 'cpu'")
    parser.add_argument("opts", default=[], nargs="*",
                        help="KEY VALUE config overrides (asf_tpu_torch/config/defaults.py)")
    if argv is None and len(sys.argv) == 1:
        parser.print_help()
    # REMAINDER would swallow --cfg after the audio path: leftovers are
    # KEY VALUE overrides instead.
    args, extra = parser.parse_known_args(argv)
    args.opts = list(args.opts) + list(extra)
    return args


def read_labels(fname):
    """Class-id -> key list from an EPIC classes csv."""
    with open(fname, newline="") as csvfile:
        return [d["key"] for d in csv.DictReader(csvfile)]


def resample_linear(wave: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Linear resampling on the host."""
    if sr == target_sr:
        return wave
    n_out = int(round(len(wave) * target_sr / sr))
    x_out = np.arange(n_out, dtype=np.float64) * (sr / target_sr)
    return np.interp(x_out, np.arange(len(wave), dtype=np.float64), wave).astype(np.float32)


def read_audio(cfg, path: str) -> np.ndarray:
    """The file's mono float32 samples at ``AUDIO_DATA.SAMPLING_RATE``."""
    from ..data.vggsound import load_wav

    wave, sr = load_wav(path)
    return resample_linear(wave, sr, cfg.AUDIO_DATA.SAMPLING_RATE)


def out_frames(cfg, n_samples: int, hop: int) -> int:
    """The spectrogram's frames: the file's, at least ``NUM_FRAMES``, a
    multiple of ``ALPHA`` for a two-pathway arch (the lateral fusions)."""
    t_out = max(cfg.AUDIO_DATA.NUM_FRAMES, 1 + n_samples // hop)
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        t_out -= t_out % cfg.SLOWFAST.ALPHA
    return t_out


def load_audio(cfg, path: str, device) -> list:
    """wav file -> the pathways [(1, 1, T', F), ...] on ``device``: one
    launch of the log-mel kernel over the whole file."""
    from ..dsp.logmel import LogMelParams, log_mel_spectrogram
    from ..engine.pipeline import pack_pathways

    wave = torch.from_numpy(read_audio(cfg, path)).to(device)
    params = LogMelParams(cfg, device)
    spec = log_mel_spectrogram(wave[None], params,
                               out_frames=out_frames(cfg, wave.shape[0], params.hop))
    return pack_pathways(cfg, spec)


def load_model(cfg, device):
    """The model of ``cfg`` in eval mode with the test-time weights."""
    from ..checkpoint import manager as cu
    from ..models import build_model

    if cfg.MODEL.MODEL_NAME == "AudioSlowFastGRU":
        raise SystemExit(
            "predict supports single-clip models only (the reference's "
            "predict.py likewise assumes AudioSlowFast); set "
            "MODEL.MODEL_NAME AudioSlowFast for one-off inference.")
    model = build_model(cfg, device, torch.Generator().manual_seed(cfg.RNG_SEED))
    cu.load_test_checkpoint(cfg, model)
    return model.eval()


def _plot(preds, names, label_files, out):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        logger.warning("no score heatmaps (%s): the scores are in the .npz", e)
        return None
    fig, axes = plt.subplots(1, len(preds), figsize=(8 * len(preds), 10))
    if len(preds) == 1:
        axes = [axes]
    for ax, name, p in zip(axes, names, preds):
        scores = p.reshape(-1, p.shape[-1])
        ax.imshow(scores.T, aspect="auto")
        ax.set_title(name)
        lf = label_files.get(name)
        if lf and os.path.exists(lf):
            keys = read_labels(lf)
            ticks = np.linspace(0, len(keys) - 1, min(40, len(keys)), dtype=int)
            ax.set_yticks(ticks)
            ax.set_yticklabels(np.asarray(keys)[ticks])
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    logger.info("Saved score heatmaps to %s", out)
    return out


def main(argv=None):
    """Returns the heads' probabilities as numpy arrays."""
    from ..utils.parser import load_config
    from ..utils.torch_setup import disable_tf32, resolve_device

    args = parse_args(argv)
    cfg = load_config(args)
    device = resolve_device(args.device)
    disable_tf32()
    setup_logging(cfg.OUTPUT_DIR)

    model = load_model(cfg, device)
    with torch.inference_mode():
        preds = model(load_audio(cfg, args.path, device))
    if not isinstance(preds, (list, tuple)):
        preds = [preds]
    preds = [p.float().cpu().numpy() for p in preds]
    for p in preds:
        logger.info("pred shape=%s min=%.4f max=%.4f", p.shape, p.min(), p.max())

    names = ["verb", "noun"] if len(preds) > 1 else ["class"]
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    npz = os.path.join(cfg.OUTPUT_DIR, "predict_scores.npz")
    np.savez(npz, **dict(zip(names, preds)))
    for name, p in zip(names, preds):
        logger.info("top-1 %s class id: %d", name, int(p.reshape(-1, p.shape[-1]).sum(0).argmax()))
    logger.info("Saved scores to %s", npz)
    label_files = {"verb": os.path.join(args.labels_dir, "EPIC_100_verb_classes.csv"),
                   "noun": os.path.join(args.labels_dir, "EPIC_100_noun_classes.csv")}
    _plot(preds, names, label_files, os.path.join(cfg.OUTPUT_DIR, "predict_scores.png"))
    return preds


if __name__ == "__main__":
    main()
