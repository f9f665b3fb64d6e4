"""The benchmark's data, found by name: cells, configurations, traffic, limits, metrics.

* ``BENCHMARK.json`` at the checkout's root lists the cells (``workloads``),
  configurations and metrics;
* ``port_bench/configs/<config>.json``: the published YAML (``published``),
  the port's defaults that the YAML leaves unstated but the run depends on
  (``port_defaults``) and each key changed from the YAML with its reason
  (``departures``); the configuration as run is the three merged in that
  order;
* ``port_bench/traffic/<traffic>.json``: the traffic mix (``traffic.py``);
* ``port_bench/workloads/<cell>.json``: the cell's correctness limits;
* ``port_bench/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(run)`` that returns a number or None.

A later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes for it.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def dotted(d: dict, key: str, value) -> dict:
    """``d`` with ``value`` at the dotted ``key``."""
    head, *rest = key.split(".")
    out = copy.deepcopy(d)
    out[head] = dotted(out.get(head, {}), ".".join(rest), value) if rest else value
    return out


def config_as_run(doc: dict) -> dict:
    cfg = merge(doc["published"], doc["port_defaults"])
    for key, dep in doc["departures"].items():
        cfg = dotted(cfg, key, dep["value"])
    return cfg


def numbers(cfg: dict) -> dict:
    """The model's and the front end's numbers, read from a configuration as run."""
    a, r, s, mdl = cfg["AUDIO_DATA"], cfg["RESNET"], cfg["SLOWFAST"], cfg["MODEL"]
    gru = mdl["MODEL_NAME"] == "AudioSlowFastGRU"
    return {
        "sampling_rate": a["SAMPLING_RATE"], "n_fft": a["N_FFT"], "window_ms": a["WINDOW_LENGTH"],
        "hop_ms": a["HOP_LENGTH"], "n_mels": a["NUM_FREQUENCIES"], "num_frames": a["NUM_FRAMES"],
        "clip_s": a["CLIP_SECS"], "overlap_s": a["SPECTROGRAM_OVERLAP"],
        "max_windows": a["MAX_NB_SPECTROGRAMS"] if gru else 1,
        "depth": r["DEPTH"], "width": r["WIDTH_PER_GROUP"], "beta_inv": s["BETA_INV"],
        "alpha": s["ALPHA"], "fusion_ratio": s["FUSION_CONV_CHANNEL_RATIO"],
        "fusion_kernel": s["FUSION_KERNEL_SZ"],
        "num_block_temp_kernel": r["NUM_BLOCK_TEMP_KERNEL"],
        "frequency_strides": r["FREQUENCY_STRIDES"],
        "frequency_dilations": r["FREQUENCY_DILATIONS"],
        "num_classes": list(mdl["NUM_CLASSES"])[:2], "dropout": mdl["DROPOUT_RATE"],
        "gru_layers": mdl.get("GRU_NUM_LAYERS", 0) if gru else 0,
        "gru_hidden": mdl.get("GRU_HIDDEN_SIZE", 0),
        "compute_dtype": cfg["GPU"]["COMPUTE_DTYPE"],
        "dsp_bf16": str(cfg["GPU"]["DSP_PRECISION"]).upper() != "HIGHEST",
    }


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def cfg(self) -> dict:
        return config_as_run(self.config)

    @property
    def m(self) -> dict:
        return numbers(self.cfg)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, cell_e2e: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in cell_e2e


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config=_json(os.path.join(ROOT, conf["file"])),
                traffic=_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")),
                limits=_json(os.path.join(HERE, "workloads", f"{name}.json"))["limits"],
                chips=int(entry["chips"]), end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
