"""The one traffic generator: an EPIC-KITCHENS-like split from a traffic file and a seed.

A traffic file (``port_bench/traffic/<name>.json``) gives:

* ``kind``: ``train`` (the window drives ``train_epoch``) or ``test``
  (``perform_test``);
* ``durations``: the law of the actions' lengths, ``{"law": "lognormal",
  "median_s", "sigma", "min_s", "max_s"}``; the ``unique_actions`` lengths are
  its stratified quantiles, ``quantile((i + 0.5) / n)``, rounded to 10 ms, so
  that every seed has the same multiset;
* ``unique_actions``, ``repeats``: the split has ``unique_actions *
  repeats`` rows, each one of the unique actions with labels of its own;
* ``actions_per_hour`` and ``videos``: the archive's length, at that density
  of actions, cut into that many videos;
* ``layout_seed``: a fixed seed that orders the lengths and places the
  actions in the videos, so that every run of a cell has the same layout;
* ``check_steps``, ``warmup_steps``: the steps set-up drives through the
  window's own loop before the window, the first ``check_steps`` of them
  compared with the plain reference.

The run's ``--seed`` draws the audio (int16 noise whose gain and spectral
tilt, ``x[t] = w[t] + c * w[t - 1]`` with c in [-0.9, 0.9], change every
100 ms, so that clips differ in their spectra), the rows' verb and noun
classes and, elsewhere, the weights.
The train rows are assigned to actions so that the loader's first epoch
(its order is ``numpy.random.default_rng(RNG_SEED).shuffle``, the JAX
package's) visits the unique actions in turn: any ``unique_actions``
consecutive items of that order are distinct actions. Test rows are in
action order, each scored in ``TEST.NUM_ENSEMBLE_VIEWS`` views.

``write(...)`` writes the archive (``asf_tpu_torch.data.hdf5.Writer``, int16,
one dataset a video) and the annotation list of the split as a pickled list
of dicts, and returns a ``Split`` that keeps the audio in memory for the
reference.
"""

from __future__ import annotations

import math
import os
import pickle
import statistics
from dataclasses import dataclass

import numpy as np

GAIN_SECS = 0.1  # the audio's gain and tilt change this often


def durations_cs(t: dict) -> np.ndarray:
    """The unique actions' lengths in centiseconds, in the layout's order."""
    d = t["durations"]
    if d["law"] != "lognormal":
        raise ValueError(f"unknown law {d['law']!r}")
    n = int(t["unique_actions"])
    z = statistics.NormalDist()
    secs = [d["median_s"] * math.exp(d["sigma"] * z.inv_cdf((i + 0.5) / n)) for i in range(n)]
    cs = np.clip(np.round(np.asarray(secs) * 100.0), d["min_s"] * 100, d["max_s"] * 100)
    return np.random.default_rng(int(t["layout_seed"])).permutation(cs.astype(np.int64))


@dataclass
class Split:
    """The generated split: each row's video, first sample and samples, its
    classes, the unique action it plays, and every video's audio (int16)."""

    video: np.ndarray
    start: np.ndarray
    num: np.ndarray
    verb: np.ndarray
    noun: np.ndarray
    action: np.ndarray
    audio: list
    archive: str
    annotations: str
    bytes_written: int


def _stamp(cs: int) -> str:
    s, c = divmod(int(cs), 100)
    return f"{s // 3600:02d}:{s % 3600 // 60:02d}:{s % 60:02d}.{c:02d}"


def write(t: dict, cfg_numbers: dict, seed: int, root: str, rng_seed: int,
          num_classes: tuple) -> Split:
    """The split of traffic ``t`` for ``seed`` under ``root``."""
    sr = int(cfg_numbers["sampling_rate"])
    cs = durations_cs(t)
    n_act, n_vid = len(cs), int(t["videos"])
    layout = np.random.default_rng([int(t["layout_seed"]), 1])
    # a chain reads up to MAX_NB windows a second apart, each a clip long
    reach_cs = np.maximum(cs, int(math.ceil((cfg_numbers.get("max_windows", 1) + 1) * 100)))
    video_cs = int(math.ceil(n_act / n_vid / float(t["actions_per_hour"]) * 360000))
    video_cs = max(video_cs, int(reach_cs.max()) + 100)
    act_video = np.arange(n_act) % n_vid
    act_start_cs = np.floor(layout.random(n_act) * (video_cs - reach_cs)).astype(np.int64)

    rng = np.random.default_rng([int(seed) % (2**63), 7])
    samples = video_cs * sr // 100
    segs = samples // int(sr * GAIN_SECS) + 1
    gains = np.exp(rng.normal(0.0, 0.7, (n_vid, segs)))
    tilts = rng.uniform(-0.9, 0.9, (n_vid, segs))
    audio = []
    archive = os.path.join(root, "audio.hdf5")
    from asf_tpu_torch.data import hdf5

    with hdf5.Writer(archive) as out:
        for v in range(n_vid):
            w = rng.integers(-3000, 3000, samples, dtype=np.int16).astype(np.float32)
            g = np.repeat(gains[v].astype(np.float32), int(sr * GAIN_SECS))[:samples]
            c = np.repeat(tilts[v].astype(np.float32), int(sr * GAIN_SECS))[:samples]
            x = w.copy()
            x[1:] += c[1:] * w[:-1]  # a spectral tilt of its own every 100 ms
            x = np.clip(x * g, -32768, 32767).astype(np.int16)
            out.add(f"P01_{v:03d}", x)
            audio.append(x)

    repeats = int(t["repeats"])
    n_rows = n_act * repeats
    if t["kind"] == "train":
        order = np.arange(n_rows)
        np.random.default_rng(int(rng_seed)).shuffle(order)
        action = np.empty(n_rows, np.int64)
        action[order] = np.arange(n_rows) % n_act
    else:
        action = np.arange(n_rows) % n_act
    verb = rng.integers(0, num_classes[0], n_rows)
    noun = rng.integers(0, num_classes[1], n_rows)
    rows = []
    for r in range(n_rows):
        a = int(action[r])
        rows.append({"narration_id": f"P01_{r:06d}", "participant_id": "P01",
                     "video_id": f"P01_{act_video[a]:03d}",
                     "start_timestamp": _stamp(act_start_cs[a]),
                     "stop_timestamp": _stamp(act_start_cs[a] + cs[a]),
                     "verb_class": int(verb[r]), "noun_class": int(noun[r])})
    annotations = os.path.join(root, "split.pkl")
    with open(annotations, "wb") as f:
        pickle.dump(rows, f)
    per_cs = sr // 100
    return Split(video=act_video[action], start=act_start_cs[action] * per_cs,
                 num=cs[action] * per_cs, verb=verb, noun=noun, action=action, audio=audio,
                 archive=archive, annotations=annotations,
                 bytes_written=os.path.getsize(archive) + os.path.getsize(annotations))
