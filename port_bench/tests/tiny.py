"""A tiny cell of each kind for the CPU tests: the cells' configurations with a
depth-26, width-8 trunk at 8 kHz over 1.279 s clips of 256 frames and 32 mels,
and small splits."""

from __future__ import annotations

import copy
import json
import os

from port_bench import spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "AUDIO_DATA": {"SAMPLING_RATE": 8000, "N_FFT": 256, "NUM_FREQUENCIES": 32,
                   "CLIP_SECS": 1.279, "NUM_FRAMES": 256, "MAX_NB_SPECTROGRAMS": 8,
                   "SPECTROGRAM_OVERLAP": 0.1},
    "RESNET": {"DEPTH": 26, "WIDTH_PER_GROUP": 8},
    "MODEL": {"GRU_HIDDEN_SIZE": 16},
    "TRAIN": {"BATCH_SIZE": 8}, "TEST": {"BATCH_SIZE": 20},
    "LOG_PERIOD": 2,
    # PyTorch's CPU bf16 convolution gives NaN at some of these shapes
    "GPU": {"COMPUTE_DTYPE": "float32"},
}
BATCH = {"epic-gru-train-b16": 4}


def _json(path):
    with open(path) as f:
        return json.load(f)


def cell(name: str, unique: int = 48, repeats: int = 3) -> spec.Cell:
    bench = spec.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(os.path.join(spec.ROOT, conf["file"]))
    tiny = copy.deepcopy(TINY)
    if name in BATCH:
        tiny["TRAIN"]["BATCH_SIZE"] = BATCH[name]
    config["port_defaults"] = spec.merge(config["port_defaults"], tiny)
    t = _json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    t.update(unique_actions=unique, repeats=repeats, videos=2, warmup_steps=2)
    full = spec.cell(name, bench)
    return spec.Cell(name=name, config=config, traffic=t, limits=full.limits, chips=1,
                     end_to_end=full.end_to_end, per_layer=full.per_layer)
