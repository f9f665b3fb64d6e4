"""The steady state of ``train(cfg)`` on one card: ms per iteration, the
data wait, and the loader alone.

    python -m asf_tpu_torch.tools.loop_probe [--steps 20] [--file-secs 10]
        [--workers 8 6]

Writes a synthetic VGG-Sound set into a temporary directory (seeded mono
int16 wav files at the flagship's 24 kHz, 309 classes; ``--steps`` x 64
train files and 64 val files of ``--file-secs`` seconds: VGG-Sound's clips
are 10 s) and, on the current CUDA device, with the flagship SlowFast-R50
and the bf16 front end at B = 64:

1. the loader alone, for each ``--workers``: the first batch of a new
   loader (its worker processes start), then, after the rest of that pass,
   a second pass of ``--steps`` batches read and collated by those
   processes (ms a batch: the pass's wall over ``--steps``);
2. ``train_entry``'s step on one batch already on the card (CUDA events):
   the step the loop runs, without the data path; then, for each
   ``--workers``, the same step while a thread beside it drains a loader of
   that many processes without pause (as the prefetcher's thread would
   with no bound on its queue), and the share of a core that thread used;
3. ``train(cfg)`` for two epochs of ``--steps`` steps with the first
   ``--workers`` (no precise BN; the val epoch that ends the run is not
   timed). Epoch 1's wall runs from train's "Start epoch" line to its
   ``train_epoch`` record (which waits for the last step) and holds the
   workers' start in its first iteration; epoch 2's runs from that record
   to its own. The steady state is epoch 2's wall less its first iteration
   (which waits for the first batch of the new pass) over the other steps;
   beside it the median ``dt`` and ``dt_data`` of epoch 2's ``train_iter``
   records (host clock, no sync a step), and epoch 1 read the same way.

The device store and the val replay are off (the three
``GPU.*_DEVICE_CACHE_MB`` at 0): the probe measures the streamed loader.
The files are in the page cache when they are read; files on a disk or a
network share read slower. The CPU cores this process may run on
(``os.sched_getaffinity``) are printed beside the worker count. Needs a GPU.
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


def write_vggsound(root: str, cfg, n_train: int, n_val: int, secs: float,
                   n_test: int = 0) -> None:
    """A synthetic VGG-Sound set in ``root``: seeded mono int16 wav files of
    ``secs`` at the config's rate, and list-of-dicts annotation pickles
    (``train.pkl``, ``val.pkl``, and ``test.pkl`` when ``n_test``) that need
    no pandas to read; ``cfg``'s ``VGGSOUND`` node points at them."""
    from scipy.io import wavfile

    sr, n_classes = cfg.AUDIO_DATA.SAMPLING_RATE, cfg.MODEL.NUM_CLASSES[0]
    rng = np.random.default_rng(5)
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        if not n:
            continue
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
    if n_test:
        cfg.VGGSOUND.TEST_LIST = "test.pkl"


class StatsLog(logging.Handler):
    """Keeps the ``json_stats`` records logged under ``asf_tpu_torch`` while
    it is attached, each with the host time it was logged at (``_at``), the
    times of ``train``'s "Start epoch" lines (``starts``, the epochs in
    ``start_epochs``) and the messages of the warnings (``warnings``)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records, self.starts, self.start_epochs, self.warnings = [], [], [], []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("json_stats: "):
            self.records.append({**json.loads(msg[len("json_stats: "):]), "_at": record.created})
        elif msg.startswith("Start epoch: "):
            self.starts.append(record.created)
            self.start_epochs.append(int(msg[len("Start epoch: "):]))
        elif record.levelno >= logging.WARNING:
            self.warnings.append(msg)

    def of(self, kind: str, since: int = 0) -> list:
        return [r for r in self.records[since:] if r["_type"] == kind]

    def __enter__(self):
        logging.getLogger("asf_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("asf_tpu_torch").removeHandler(self)


def drain(cfg, workers: int, stop: threading.Event, started: threading.Event,
          out: dict) -> None:
    """Reads the train batches of ``workers`` processes epoch after epoch,
    without pause, until ``stop`` is set; ``started`` is set once the first
    batch is in. ``out`` gets the batches read after the first, the wall
    seconds they took and the CPU seconds this thread spent on them
    (receiving and unpickling them in this process)."""
    from ..data.loader import construct_loader, shuffle_dataset

    cfg = cfg.clone()
    cfg.DATA_LOADER.NUM_WORKERS = workers
    ld = construct_loader(cfg, "train")
    n = 0
    try:
        for epoch in itertools.count():
            shuffle_dataset(ld, epoch)
            for _ in ld:
                if n == 0:
                    started.set()
                    wall0, cpu0 = time.perf_counter(), time.thread_time()
                n += 1
                if stop.is_set():
                    out.update(batches=n - 1, wall_s=time.perf_counter() - wall0,
                               cpu_s=time.thread_time() - cpu0)
                    return
    finally:
        ld.close()


def loader_pass_ms(cfg, workers: int, n: int) -> tuple[float, float]:
    """Host ms of the first train batch of a new loader (its workers start),
    and ms a batch over the second of two whole passes of ``n`` batches (the
    pass's wall / n), read and collated by ``workers`` processes."""
    from ..data.loader import construct_loader, shuffle_dataset

    cfg = cfg.clone()
    cfg.DATA_LOADER.NUM_WORKERS = workers
    ld = construct_loader(cfg, "train")
    try:
        t0 = time.perf_counter()
        it = iter(ld)
        next(it)
        first_ms = (time.perf_counter() - t0) * 1e3
        for _ in it:  # the rest of the pass: no request left in flight
            pass
        shuffle_dataset(ld, 1)
        t0 = time.perf_counter()
        got = sum(1 for _ in ld)
        return first_ms, (time.perf_counter() - t0) * 1e3 / got
    finally:
        ld.close()


def step_ms(cfg, workers: list, reps: int = 10) -> tuple[float, dict]:
    """CUDA-event ms of ``train_entry``'s step at B = 64 (after 3 warm
    steps) alone, and for each of ``workers`` the same step while a thread
    beside it drains a train loader of that many processes (``drain``),
    with what that thread read."""
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

    alone, beside = timed(), {}
    for w in workers:
        stop, started, read = threading.Event(), threading.Event(), {}
        reader = threading.Thread(target=drain, args=(cfg, w, stop, started, read))
        reader.start()
        if not started.wait(timeout=300):  # the workers started and reading
            raise RuntimeError("the loader gave no batch in 300 s")
        ms = timed()
        stop.set()
        reader.join()
        beside[w] = {"ms": ms, **read}
    return alone, beside


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
    cores = len(os.sched_getaffinity(0))

    cfg = flagship_cfg()
    cfg.GPU.DSP_PRECISION = "BFLOAT16"
    cfg.TRAIN.BATCH_SIZE = BATCH
    cfg.BN.USE_PRECISE_STATS = False
    cfg.SOLVER.MAX_EPOCH = 2
    cfg.LOG_PERIOD = 1
    cfg.LOG_MODEL_INFO = False
    cfg.DATA_LOADER.NUM_WORKERS = args.workers[0]
    # the streamed path this probe measures: no device store, no val replay
    cfg.GPU.TRAIN_DEVICE_CACHE_MB = cfg.GPU.TEST_DEVICE_CACHE_MB = 0
    cfg.GPU.VAL_DEVICE_CACHE_MB = 0
    result = {"card": card, "steps": args.steps, "file_secs": args.file_secs, "batch": BATCH,
              "cores": cores}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_vggsound(root, cfg, args.steps * BATCH, BATCH, args.file_secs)
        print(f"[loop] wrote {args.steps * BATCH} + {BATCH} wav files of {args.file_secs} s in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cfg.OUTPUT_DIR = os.path.join(root, "out")

        result["loader"] = {}
        for w in args.workers:
            first_ms, pass_ms = loader_pass_ms(cfg, w, args.steps)
            result["loader"][w] = {"first_ms": first_ms, "ms": pass_ms}
            print(f"[loop] loader alone, {w} worker processes on {cores} cores: {pass_ms:.3f} ms "
                  f"a batch of {BATCH} (a second pass of {args.steps} batches, wall / "
                  f"{args.steps}); the first batch of the first pass {first_ms:.1f} ms "
                  f"(the workers start) | {card}", flush=True)

        result["step_ms"], result["beside"] = step_ms(cfg, args.workers)
        for w, r in result["beside"].items():
            print(f"[loop] train_entry step at B={BATCH}: {result['step_ms']:.3f} ms alone, "
                  f"{r['ms']:.3f} ms with a thread beside it draining a loader of {w} worker "
                  f"processes on {cores} cores ({r['ms'] / result['step_ms']:.3f} of alone; "
                  f"CUDA events); that thread took {r['batches']} batches in {r['wall_s']:.3f} s "
                  f"({r['wall_s'] / max(r['batches'], 1) * 1e3:.3f} ms apart) on "
                  f"{r['cpu_s'] / r['wall_s']:.3f} of a core | {card}", flush=True)

        with StatsLog() as stats:
            torch.cuda.synchronize()
            train(cfg)
            torch.cuda.synchronize()
        iters = stats.of("train_iter")
        epochs = stats.of("train_epoch")
        n = args.steps
        # Epoch 1: from train's "Start epoch" line, the workers' start included.
        wall1 = epochs[0]["_at"] - stats.starts[0]
        first1 = iters[0]["dt"]
        # Epoch 2: from epoch 1's record to its own, the workers up.
        wall2 = epochs[1]["_at"] - epochs[0]["_at"]
        first2 = iters[n]["dt"]
        steady = iters[n + 1 :]
        result.update(
            epoch1_wall_s=wall1, epoch1_first_iter_s=first1,
            epoch1_steady_ms=(wall1 - first1) / (n - 1) * 1e3,
            epoch2_wall_s=wall2, epoch2_first_iter_s=first2,
            steady_ms=(wall2 - first2) / (n - 1) * 1e3,
            iter_dt_ms=statistics.median(r["dt"] for r in steady) * 1e3,
            iter_dt_data_ms=statistics.median(r["dt_data"] for r in steady) * 1e3,
        )
        result["steady_over_step"] = result["steady_ms"] / result["step_ms"]
        result["wait_share"] = result["iter_dt_data_ms"] / result["iter_dt_ms"]
        print(f"[loop] train(cfg), 2 epochs of {n} steps with {args.workers[0]} loader workers: "
              f"epoch 1 wall {wall1:.4f} s, first iteration {first1:.4f} s, "
              f"{result['epoch1_steady_ms']:.3f} ms an iteration after it ((wall - first) / "
              f"{n - 1}); epoch 2 wall {wall2:.4f} s (record to record), first iteration "
              f"{first2:.4f} s, steady state {result['steady_ms']:.3f} ms an iteration "
              f"({result['steady_over_step']:.3f} of the step); epoch 2's train_iter median dt "
              f"{result['iter_dt_ms']:.3f} ms, dt_data {result['iter_dt_data_ms']:.3f} ms "
              f"({result['wait_share']:.3f} of dt) | {card}", flush=True)
        print(f"[loop] every iteration (dt s, dt_data s): "
              f"{[(r['dt'], r['dt_data']) for r in iters]}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
