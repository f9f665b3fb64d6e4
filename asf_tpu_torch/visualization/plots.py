"""Plot helpers: confusion matrices, top-k histograms, spectrograms, waveforms.

Copy of ``asf_tpu/visualization/plots.py``: matplotlib is imported inside
each function, with the Agg backend (files, never a window), so that the
package imports without it.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cmtx, class_names=None, figsize=(8, 8)):
    plt = _pyplot()
    n = cmtx.shape[0]
    if class_names is None or not isinstance(class_names, list):
        class_names = [str(i) for i in range(n)]

    fig = plt.figure(figsize=figsize)
    plt.imshow(cmtx, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar()
    tick_marks = np.arange(len(class_names))
    plt.xticks(tick_marks, class_names, rotation=45)
    plt.yticks(tick_marks, class_names)
    threshold = cmtx.max() / 2.0 if cmtx.max() else 0.5
    for i in range(n):
        for j in range(n):
            color = "white" if cmtx[i, j] > threshold else "black"
            plt.text(j, i, format(int(cmtx[i, j]), "d"), ha="center", color=color)
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    return fig


def plot_topk_histogram(tag, array, k=10, class_names=None, figsize=(8, 8)):
    plt = _pyplot()
    val, ind = np.sort(array)[::-1][:k], np.argsort(array)[::-1][:k]
    fig = plt.figure(figsize=figsize)
    if class_names is None:
        names = [str(i) for i in ind]
    else:
        names = [class_names[i] for i in ind]
    # fewer classes than k: bars over the classes there are
    plt.bar(range(len(val)), val)
    plt.xticks(range(len(val)), names, rotation=45)
    plt.title(tag)
    plt.tight_layout()
    return fig


def plot_spectrogram(spec, sr=24000, hop=120, figsize=(10, 4)):
    """A (T, F) log-mel spectrogram."""
    plt = _pyplot()
    fig = plt.figure(figsize=figsize)
    plt.pcolormesh(np.asarray(spec).T, shading="auto")
    plt.xlabel(f"frames (hop {hop / sr * 1e3:.1f} ms)")
    plt.ylabel("mel bin")
    plt.colorbar(label="log-mel")
    plt.tight_layout()
    return fig


def plot_waveform(waveform, sample_rate, title="Waveform", figsize=(10, 4)):
    """A time-domain waveform, one axis a channel."""
    plt = _pyplot()
    waveform = np.atleast_2d(np.asarray(waveform))
    num_channels, num_frames = waveform.shape
    time_axis = np.arange(num_frames) / sample_rate

    fig, axes = plt.subplots(num_channels, 1, figsize=figsize, squeeze=False)
    for c in range(num_channels):
        ax = axes[c][0]
        ax.plot(time_axis, waveform[c], linewidth=1)
        ax.grid(True)
        if num_channels > 1:
            ax.set_ylabel(f"Channel {c + 1}")
    fig.suptitle(title)
    return fig
