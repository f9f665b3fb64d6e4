"""Render the slow and fast spectrograms of a dataset item to PNG.

    python -m asf_tpu_torch.visualization.spectrograms -i 3 --cfg cfg.yaml [--device cpu]

Counterpart of ``asf_tpu/visualization/spectrograms.py``: an item of
``EpicKitchens`` and of ``EpicKitchensGRUwithPDDL`` goes through the port's
input pipeline (``engine/pipeline.py``: the log-mel kernel on the card, its
plain version on the CPU) without augmentation, and each pathway is saved
with matplotlib under ``res/dataloader/<regular|gru>/`` (a GRU item: its
first window). Runs on the current CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def plot_spectrograms(spectrograms, index: int, prefix: str = "", d_type: str = "regular",
                      output_root: str = "res/dataloader") -> list:
    """``spectrograms``: [slow, fast] (or one) arrays of (T, F), or of (N, T, F)
    for a chain of windows; returns the files written."""
    names = ("slow", "fast") if len(spectrograms) == 2 else ("spec",)
    out = []
    for name, sg in zip(names, spectrograms):
        sg = np.asarray(sg)
        while sg.ndim > 2:  # a chain of windows: the first
            sg = sg[0]
        out.append(_plot_spectrogram(sg, index, prefix, name, d_type, output_root))
    return out


def _plot_spectrogram(spec: np.ndarray, index: int, prefix: str, s_type: str, d_type: str,
                      output_root: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_path = os.path.join(output_root, d_type)
    os.makedirs(output_path, exist_ok=True)
    plt.figure(figsize=(10, 10))
    # (T, F) -> mel bins on y, time on x, low frequencies at the bottom
    plt.imshow(spec.T, vmin=-6, vmax=3, cmap="magma", origin="lower", aspect="auto")
    plt.colorbar(label="dB")
    plt.title(f"Mel spectrogram for sample {index} ({prefix})", fontsize=18)
    plt.xlabel("Time", fontsize=15)
    plt.ylabel("Mel-Frequency bins", fontsize=15)
    out = os.path.join(output_path, f"{s_type}_{index}_{prefix}_{d_type}.png")
    plt.savefig(out)
    plt.close()
    return out


def _item_pathways(cfg, item, device) -> list:
    """A dataset item's host waveform -> its pathway spectrograms, (T, F) or
    (N, T, F) numpy arrays, through the input pipeline the model is fed by."""
    from ..engine.pipeline import make_input_pipeline

    pipeline = make_input_pipeline(cfg, device)
    wave = torch.from_numpy(np.asarray(item["waveform"]))[None].to(device)
    n_valid = torch.as_tensor(np.asarray(item["n_valid"])).reshape(
        (1, -1) if wave.dim() == 3 else (1,)).to(device)
    paths = pipeline(wave, n_valid, train=False)
    # (1, 1, T, F) -> (T, F); a chain's (1, N, 1, T, F) -> (N, T, F)
    return [p[0].squeeze(-3).float().cpu().numpy() for p in paths]


def run(index: int, cfg_file: str | None = None, device=None) -> None:
    from ..config import get_cfg
    from ..data.build import build_dataset
    from ..utils.torch_setup import resolve_device

    device = resolve_device(device)
    cfg = get_cfg()
    if cfg_file:
        cfg.merge_from_file(cfg_file)

    regular = build_dataset("EpicKitchens", cfg, "train")
    plot_spectrograms(_item_pathways(cfg, regular[index], device), index=index,
                      d_type="regular")

    gru = build_dataset("EpicKitchensGRUwithPDDL", cfg, "train")
    plot_spectrograms(_item_pathways(cfg, gru[index], device), index=index, d_type="gru")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--index", type=int, required=True)
    parser.add_argument("--cfg", dest="cfg_file", default=None)
    parser.add_argument("--device", default=None,
                        help="Device to run on: the current CUDA device unless 'cpu'")
    args = parser.parse_args()
    run(index=args.index, cfg_file=args.cfg_file, device=args.device)
