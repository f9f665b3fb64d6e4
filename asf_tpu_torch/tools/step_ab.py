"""Interleaved timings of the flagship's B = 64 train step in several checkouts, on one card.

    python -m asf_tpu_torch.tools.step_ab [--rounds R] [--runs N] DIR [DIR ...]

Each DIR is the root of a checkout of the repo (this one is "."). Every
round starts one process a DIR, in the order given and then in the reverse
order (A B B A), so that a drift of the card or the host over the call
falls on both sides alike. A process builds ``entry.train_entry(batch=64)``
(the bf16 flagship with SpecAugment and nesterov SGD: ``chip_smoke.py``
phase 4's step), takes 3 warm-up steps, then times ``--runs`` runs of 10
steps each: CUDA events around the 10 steps, and the host clock. Prints one
line a process and then, for each DIR, every run's ms a step, their median
and their range, beside the card's name. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys, time
import torch
from asf_tpu_torch.entry import train_entry
from asf_tpu_torch.utils.lr_policy import get_lr_at_epoch

torch.manual_seed(0)
step, (state, example) = train_entry(batch=64)
lr = get_lr_at_epoch(step.pipeline.cfg, 200.0)
for _ in range(3):
    step(state, example, lr)
torch.cuda.synchronize()
card, wall = [], []
for _ in range(int(sys.argv[1])):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(10):
        step(state, example, lr)
    end.record()
    end.synchronize()
    wall.append((time.perf_counter() - t0) * 100.0)
    card.append(start.elapsed_time(end) / 10)
print("STEP_AB " + json.dumps({"card_ms": card, "wall_ms": wall,
                               "kind": torch.cuda.get_device_name(0)}))
"""


def time_tree(root: str, runs: int) -> dict:
    """One process in checkout ``root``: its runs' ms a step."""
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(runs)], cwd=root, env=env,
                          capture_output=True, text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("STEP_AB ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("STEP_AB "):])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    got = {d: {"card_ms": [], "wall_ms": []} for d in args.dirs}
    kind = None
    for r in range(args.rounds):
        for d in args.dirs + args.dirs[::-1]:
            res = time_tree(d, args.runs)
            kind = res["kind"]
            for k in ("card_ms", "wall_ms"):
                got[d][k] += res[k]
            print(f"[step_ab] round {r + 1} {d}: card ms a step "
                  f"{[round(v, 3) for v in res['card_ms']]}, wall "
                  f"{[round(v, 3) for v in res['wall_ms']]}", flush=True)
    for d, res in got.items():
        c, w = res["card_ms"], res["wall_ms"]
        print(f"[step_ab] {d}: {len(c)} runs of 10 steps; card ms a step median "
              f"{statistics.median(c):.3f} (range {min(c):.3f}-{max(c):.3f}), wall median "
              f"{statistics.median(w):.3f} (range {min(w):.3f}-{max(w):.3f}) | {kind}",
              flush=True)


if __name__ == "__main__":
    main()
