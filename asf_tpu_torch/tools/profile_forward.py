"""Where the time of the port's eval forward or train step goes, on the card.

    python -m asf_tpu_torch.tools.profile_forward [--batch 128] [--dsp BFLOAT16]
        [--train] [--wide] [--trace runs/forward_trace.json]

Runs ``entry(batch, dsp_precision)`` (with ``--train``:
``train_entry(batch, dsp_precision)``, SpecAugment on, nesterov SGD at a
fixed LR) on the current CUDA device: the flagship SlowFast-R50, weights
from a seed, at the flagship geometry or, with ``--wide``, the wide-window
one. It warms up, times ``STEPS`` forwards (or steps), then records
``STEPS`` more under ``torch.profiler`` (device activity only) and prints:

* wall ms per forward: the host clock around the synchronised forwards,
  without the profiler and under it (its callbacks slow the host);
* busy ms per forward: the union of the kernels' intervals on the card, and
  the card's idle share of the wall time without the profiler;
* device ms per forward by group (the log-mel kernels, convolutions, batch
  norm, the optimizer's multi-tensor updates, elementwise, pooling, other)
  and the top kernels by device time.

With ``--trace`` it also writes the Chrome trace there. Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..entry import entry, flagship_cfg, train_entry, wide_window

STEPS = 5  # forwards timed, and forwards profiled

# First matching substring of a kernel's (lower-cased) name names its group.
GROUPS = (
    ("log-mel kernel", ("logmel_",)),
    ("optimizer", ("multi_tensor",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "implicit", "wgrad", "dgrad")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_")),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, keys in GROUPS if any(k in low for k in keys)), "other")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dsp", default="BFLOAT16", choices=["HIGHEST", "BFLOAT16"])
    ap.add_argument("--train", action="store_true", help="train steps instead of forwards")
    ap.add_argument("--wide", action="store_true", help="the wide-window geometry")
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = wide_window(flagship_cfg()) if args.wide else None
    if args.train:
        step, (state, example) = train_entry(args.batch, args.dsp, cfg=cfg)

        def run():
            step(state, example, 0.01)
    else:
        fn, (model, wave, n_valid) = entry(args.batch, args.dsp, cfg=cfg)

        def run():
            fn(model, wave, n_valid)

    def wall_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / STEPS

    wall_ms()  # warm-up
    plain_wall = wall_ms()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_wall = wall_ms()
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    what = "train step" if args.train else "forward"
    tag = (f"{what} B={args.batch} DSP={args.dsp}{' wide window' if args.wide else ''} "
           f"| {card}")
    print(f"[profile] {tag}: wall {plain_wall:.3f} ms per {what}, {profiled_wall:.3f} ms "
          f"under the profiler ({STEPS} each)")
    if not kernels:
        print("[profile] the profiler recorded no device activity: busy time not measured")
        return
    busy_ms = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e3 / STEPS
    print(f"[profile] {tag}: device busy {busy_ms:.3f} ms per {what}, idle share "
          f"{1 - busy_ms / plain_wall:.3f} of the wall time without the profiler, "
          f"{len(kernels) / STEPS:.0f} kernels per {what}")
    by_group, by_name = collections.Counter(), collections.Counter()
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_group[group_of(e.name)] += us
        by_name[e.name] += us
    for g, us in by_group.most_common():
        print(f"[profile]   {g:15s} {us / 1e3 / STEPS:9.3f} ms per {what}")
    for name, us in by_name.most_common(12):
        print(f"[profile]   {us / 1e3 / STEPS:9.3f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
