"""The steady state of ``train(cfg)`` on one card: ms per iteration, the
data wait, and the loader alone.

    python -m asf_tpu_torch.tools.loop_probe [--steps 20] [--file-secs 10]
        [--workers 8 16]

Writes a synthetic VGG-Sound set into a temporary directory (seeded mono
int16 wav files at the flagship's 24 kHz, 309 classes; ``--steps`` x 64
train files and 64 val files of ``--file-secs`` seconds: VGG-Sound's clips
are 10 s) and, on the current CUDA device, with the flagship SlowFast-R50
and the bf16 front end at B = 64:

1. the loader alone, for each ``--workers``: ``--steps`` batches read and
   collated on the host by that many threads (ms a batch, after the first);
2. ``train_entry``'s step on one batch already on the card (CUDA events):
   the step the loop runs, without the data path; then the same step while
   a thread beside it reads the loader (the first ``--workers``) without
   pause, as the prefetcher's worker does in the loop;
3. ``train(cfg)`` for one epoch of ``--steps`` steps with the first
   ``--workers`` (no precise BN; the val epoch that ends the run is not
   timed): the epoch wall from train's "Start epoch" line to its
   ``train_epoch`` record, which waits for the last step, and that wall
   less the first iteration over the other steps (the steady state); the
   median ``dt`` and ``dt_data`` of the ``train_iter`` records (host clock,
   no sync a step).

The files are in the page cache when they are read; files on a disk or a
network share read slower. Needs a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import pickle
import statistics
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

BATCH = 64


def write_vggsound(root: str, cfg, n_train: int, n_val: int, secs: float) -> None:
    """A synthetic VGG-Sound set in ``root``: seeded mono int16 wav files of
    ``secs`` at the config's rate, and list-of-dicts annotation pickles
    (``train.pkl``, ``val.pkl``) that need no pandas to read."""
    from scipy.io import wavfile

    sr, n_classes = cfg.AUDIO_DATA.SAMPLING_RATE, cfg.MODEL.NUM_CLASSES[0]
    rng = np.random.default_rng(5)
    for split, n in (("train", n_train), ("val", n_val)):
        rows = []
        for i in range(n):
            name = f"{split}_{i:04d}"
            wave = (rng.standard_normal(int(sr * secs)) * 3000).astype(np.int16)
            wavfile.write(os.path.join(root, f"{name}.wav"), sr, wave)
            rows.append({"video": f"{name}.mp4", "class_id": int(rng.integers(n_classes))})
        with open(os.path.join(root, f"{split}.pkl"), "wb") as f:
            pickle.dump(rows, f)
    cfg.VGGSOUND.AUDIO_DATA_DIR = cfg.VGGSOUND.ANNOTATIONS_DIR = root
    cfg.VGGSOUND.TRAIN_LIST, cfg.VGGSOUND.VAL_LIST = "train.pkl", "val.pkl"


class StatsLog(logging.Handler):
    """Keeps the ``json_stats`` records logged under ``asf_tpu_torch`` while
    it is attached, each with the host time it was logged at (``_at``), and
    the times of ``train``'s "Start epoch" lines (``starts``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records, self.starts = [], []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("json_stats: "):
            self.records.append({**json.loads(msg[len("json_stats: "):]), "_at": record.created})
        elif msg.startswith("Start epoch: "):
            self.starts.append(record.created)

    def of(self, kind: str, since: int = 0) -> list:
        return [r for r in self.records[since:] if r["_type"] == kind]

    def __enter__(self):
        logging.getLogger("asf_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("asf_tpu_torch").removeHandler(self)


def loader_ms(cfg, workers: int, n: int, stop: threading.Event | None = None) -> list:
    """Host ms of each train batch read and collated by ``workers`` threads:
    ``n`` of them, or, with ``stop``, epoch after epoch until it is set."""
    from ..data.loader import construct_loader, shuffle_dataset

    cfg = cfg.clone()
    cfg.DATA_LOADER.NUM_WORKERS = workers
    ld = construct_loader(cfg, "train")
    out = []
    try:
        for epoch in itertools.count():
            shuffle_dataset(ld, epoch)
            t0 = time.perf_counter()
            for _ in ld:
                t1 = time.perf_counter()
                out.append((t1 - t0) * 1e3)
                t0 = t1
                if (stop is None and len(out) == n) or (stop is not None and stop.is_set()):
                    return out
    finally:
        ld.close()


def step_ms(cfg, reps: int = 10) -> tuple[float, float, list]:
    """CUDA-event ms of ``train_entry``'s step at B = 64 (after 3 warm
    steps) alone, then with a thread beside it that reads the train loader
    all the while; and the ms of the batches that thread read."""
    from ..entry import train_entry
    from ..utils.lr_policy import get_lr_at_epoch

    torch.manual_seed(0)
    step, (state, example) = train_entry(batch=BATCH, cfg=cfg)
    lr = get_lr_at_epoch(cfg, 0.0)
    for _ in range(3):
        step(state, example, lr)

    def timed() -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            step(state, example, lr)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    alone = timed()
    batches, stop = [], threading.Event()
    reader = threading.Thread(target=lambda: batches.extend(
        loader_ms(cfg, cfg.DATA_LOADER.NUM_WORKERS, 0, stop)))
    reader.start()
    time.sleep(0.3)  # the loader's threads started and reading
    beside = timed()
    stop.set()
    reader.join()
    return alone, beside, batches


def main() -> None:
    from ..engine import train
    from ..entry import flagship_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--file-secs", type=float, default=10.0)
    ap.add_argument("--workers", type=int, nargs="+", default=[8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("loop_probe needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    cfg = flagship_cfg()
    cfg.GPU.DSP_PRECISION = "BFLOAT16"
    cfg.TRAIN.BATCH_SIZE = BATCH
    cfg.BN.USE_PRECISE_STATS = False
    cfg.SOLVER.MAX_EPOCH = 1
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = args.workers[0]
    result = {"card": card, "steps": args.steps, "file_secs": args.file_secs, "batch": BATCH}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_vggsound(root, cfg, args.steps * BATCH, BATCH, args.file_secs)
        print(f"[loop] wrote {args.steps * BATCH} + {BATCH} wav files of {args.file_secs} s in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cfg.OUTPUT_DIR = os.path.join(root, "out")

        result["loader_ms"] = {}
        for w in args.workers:
            times = loader_ms(cfg, w, args.steps)
            result["loader_ms"][w] = statistics.median(times[1:])
            print(f"[loop] loader alone, {w} threads: {result['loader_ms'][w]:.3f} ms a batch of "
                  f"{BATCH} (median after the first; first {times[0]:.1f} ms) | {card}",
                  flush=True)

        result["step_ms"], result["step_beside_loader_ms"], beside = step_ms(cfg)
        result["loader_beside_step_ms"] = statistics.median(beside[1:])
        print(f"[loop] train_entry step at B={BATCH}: {result['step_ms']:.3f} ms alone, "
              f"{result['step_beside_loader_ms']:.3f} ms with a thread beside it reading the "
              f"loader ({args.workers[0]} threads), whose batches took "
              f"{result['loader_beside_step_ms']:.3f} ms (median after the first) (CUDA events) "
              f"| {card}", flush=True)

        with StatsLog() as stats:
            torch.cuda.synchronize()
            train(cfg)
            torch.cuda.synchronize()
        iters = stats.of("train_iter")
        epoch = stats.of("train_epoch")[0]
        wall = epoch["_at"] - stats.starts[0]
        first = iters[0]["dt"]
        steady = iters[1:]
        result.update(
            epoch_wall_s=wall, first_iter_s=first,
            steady_ms=(wall - first) / (len(iters) - 1) * 1e3,
            iter_dt_ms=statistics.median(r["dt"] for r in steady) * 1e3,
            iter_dt_data_ms=statistics.median(r["dt_data"] for r in steady) * 1e3,
        )
        result["steady_over_step"] = result["steady_ms"] / result["step_ms"]
        result["wait_share"] = result["iter_dt_data_ms"] / result["iter_dt_ms"]
        print(f"[loop] train(cfg), {len(iters)} steps with {args.workers[0]} loader threads: "
              f"epoch wall {wall:.4f} s, first iteration {first:.4f} s, steady state "
              f"{result['steady_ms']:.3f} ms an iteration ((wall - first) / "
              f"{len(iters) - 1}; {result['steady_over_step']:.3f} of the step); train_iter "
              f"median dt {result['iter_dt_ms']:.3f} ms, dt_data "
              f"{result['iter_dt_data_ms']:.3f} ms ({result['wait_share']:.3f} of dt) | {card}",
              flush=True)
        print(f"[loop] every iteration (dt s, dt_data s): "
              f"{[(r['dt'], r['dt_data']) for r in iters]}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
