"""EPIC-KITCHENS ``train(cfg)`` from the device store against the streamed
loader, at a realistic size, run after run in alternation on one card.

    python -m asf_tpu_torch.tools.store_probe [--pairs 3] [--workers 8]

Writes into a temporary directory an int16 HDF5 archive (``data/hdf5.py``'s
``Writer``: 18 videos of 30 min at 24 kHz, 1.55 GB, one seeded noise
rotated a video) with 800 train actions of 25-45 s (about 1.3 GB of record
segments) and 64 val rows, then, on the current CUDA device, runs
``entry.epic_cfg()``'s ``train(cfg)`` (B = 32 x 400 frames, weights from the
seed, 4 precise-BN batches, one epoch) ``--pairs`` times under the defaults
(the train split in a device store) and streamed (the three
``GPU.*_DEVICE_CACHE_MB`` at 0) through ``--workers`` loader processes, the
order alternating pair by pair. Each run prints the steady iteration (the
median ``dt`` of iterations 2 to the last), the data wait, the first
batch's wait, the CPU ms a batch of the thread that receives the train
batches (the train prefetcher's ``thread_time``) and the seconds in
``train(cfg)``; then the medians of each side, beside the card's name and
power limit. No profiler runs. The archive is in the page cache when it is
read. Needs a GPU. ``chip_smoke.py`` phase 15 runs the same archive
(``write_archive``) through ``timed_train`` once each way, with 10 steps
traced for the card's idle share.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

VIDEOS, VIDEO_SECS = 18, 1800.0
TRAIN_ROWS, VAL_ROWS, ACTION_SECS = 800, 64, (25.0, 45.0)
PRECISE = 4


def write_archive(root: str, cfg, videos: int = VIDEOS, video_secs: float = VIDEO_SECS,
                  n_train: int = TRAIN_ROWS, n_val: int = VAL_ROWS,
                  action_secs: tuple = ACTION_SECS) -> tuple[str, float]:
    """The int16 archive ``root/epic_big.hdf5`` (10 s chunks) and its lists,
    ``big_train.pkl`` (``n_train`` actions of ``action_secs``) and
    ``big_val.pkl`` (``n_val`` of 2.5-6 s), lists of dicts; points ``cfg``'s
    ``EPICKITCHENS`` node at them. Returns the archive's path and GB."""
    from ..data import hdf5

    sr = cfg.AUDIO_DATA.SAMPLING_RATE
    path = os.path.join(root, "epic_big.hdf5")
    rng = np.random.default_rng(15)
    noise = rng.integers(-9000, 9000, int(sr * video_secs), dtype=np.int16)
    with hdf5.Writer(path) as w:
        for v in range(videos):  # one seeded noise, rotated by a prime a video
            w.add(f"P02_{v:02d}", np.roll(noise, 7919 * v), 10 * sr)

    def stamp(sec: float) -> str:
        return f"{int(sec // 3600):02d}:{int(sec % 3600 // 60):02d}:{sec % 60:05.2f}"

    for split, rows_n, (lo, hi) in (("train", n_train, action_secs), ("val", n_val, (2.5, 6.0))):
        rows = []
        for i in range(rows_n):
            secs = rng.uniform(lo, hi)
            start = rng.uniform(0.0, video_secs - secs)
            rows.append({"narration_id": f"big_{split}_{i:04d}", "participant_id": "P02",
                         "video_id": f"P02_{i % videos:02d}", "start_timestamp": stamp(start),
                         "stop_timestamp": stamp(start + secs),
                         "verb_class": int(rng.integers(cfg.MODEL.NUM_CLASSES[0])),
                         "noun_class": int(rng.integers(cfg.MODEL.NUM_CLASSES[1]))})
        with open(os.path.join(root, f"big_{split}.pkl"), "wb") as f:
            pickle.dump(rows, f)
    c = cfg.EPICKITCHENS
    c.AUDIO_DATA_FILE, c.ANNOTATIONS_DIR = path, root
    c.PROCESSED_TRAIN_LIST, c.PROCESSED_VAL_LIST = "big_train.pkl", "big_val.pkl"
    return path, os.path.getsize(path) / 1e9


def timed_train(cfg, traced: tuple[int, int] = (0, 0)) -> dict:
    """``train(cfg)`` with its losses, steady iteration, data wait, first
    batch's wait (ms, ms, s), the train prefetcher thread's CPU ms a batch,
    the seconds in ``train(cfg)`` and the peak GiB on the card. The steady
    medians take iterations 2 to the last but the ``traced`` (first, count)
    ones, which run under a profiler where ``GPU.PROFILE_DIR`` is set."""
    from ..data import prefetch
    from ..engine import train
    from .loop_probe import StatsLog

    threads = []
    worker = prefetch.Prefetcher._worker

    def timed_worker(self):
        c0 = time.thread_time()
        try:
            worker(self)
        finally:
            threads.append(time.thread_time() - c0)

    prefetch.Prefetcher._worker = timed_worker
    try:
        with StatsLog() as stats:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            train(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        prefetch.Prefetcher._worker = worker
    iters = stats.of("train_iter")
    first, n = traced
    steady = [r for i, r in enumerate(iters[1:], 1) if not first <= i < first + n]
    return {"losses": [r["loss"] for r in iters],
            "it_ms": statistics.median(r["dt"] for r in steady) * 1e3,
            "wait_ms": statistics.median(r["dt_data"] for r in steady) * 1e3,
            "first_wait_s": iters[0]["dt_data"], "cpu_ms": threads[0] / len(iters) * 1e3,
            "wall_s": wall, "steps": len(iters),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def main() -> None:
    from ..entry import epic_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("store_probe needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    base = epic_cfg()
    base.SOLVER.MAX_EPOCH = 1
    base.LOG_PERIOD = 1
    base.LOG_MODEL_INFO = False
    base.BN.NUM_BATCHES_PRECISE = PRECISE
    base.DATA_LOADER.NUM_WORKERS = args.workers
    runs = {"store": [], "streamed": []}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        _, gb = write_archive(root, base)
        print(f"[store_probe] wrote {VIDEOS} videos of {VIDEO_SECS} s ({gb:.3f} GB) and "
              f"{TRAIN_ROWS} + {VAL_ROWS} rows in {time.perf_counter() - t0:.1f} s", flush=True)
        for pair in range(args.pairs):
            order = ("store", "streamed") if pair % 2 == 0 else ("streamed", "store")
            for tag in order:
                cfg = base.clone()
                cfg.OUTPUT_DIR = os.path.join(root, f"out_{pair}_{tag}")
                if tag == "streamed":
                    cfg.GPU.TRAIN_DEVICE_CACHE_MB = cfg.GPU.TEST_DEVICE_CACHE_MB = 0
                    cfg.GPU.VAL_DEVICE_CACHE_MB = 0
                r = timed_train(cfg)
                runs[tag].append(r)
                print(f"[store_probe] pair {pair + 1} {tag}: {r['steps']} steps at B = "
                      f"{cfg.TRAIN.BATCH_SIZE}, steady iteration {r['it_ms']:.3f} ms, data wait "
                      f"{r['wait_ms']:.3f} ms, first batch's wait {r['first_wait_s']:.4f} s, "
                      f"receiving thread {r['cpu_ms']:.3f} CPU ms a batch, "
                      f"{r['wall_s']:.1f} s in train(cfg) | {card}", flush=True)
    medians = {tag: {k: statistics.median(r[k] for r in rs) for k in rs[0] if k != "losses"}
               for tag, rs in runs.items()}
    for tag, m in medians.items():
        print(f"[store_probe] {tag}, median of {args.pairs}: steady iteration "
              f"{m['it_ms']:.3f} ms, data wait {m['wait_ms']:.3f} ms, first batch's wait "
              f"{m['first_wait_s']:.4f} s, receiving thread {m['cpu_ms']:.3f} CPU ms a batch | "
              f"{card}", flush=True)
    print(json.dumps({"card": card, "runs": runs, "medians": medians}))


if __name__ == "__main__":
    main()
