"""The readings the correctness limits are set from, on the card, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed: the cell's set-up, check steps and a short window
(``--seconds``), then, one JSON line a seed, the numbers compared: the
program against the reference (the lower reading) and, on the first
``--control-seeds`` seeds, the reference one precision below the
configuration's in the program's place (the control: a float8 trunk, and a
bf16 front end under a float32 one) and the reference with a planted fault in the program's place
(a train cell: the loss over half the batch; a test cell: each view scored
as the next item).
A state left unchanged reads 1 on the gradient and change gaps and needs no
run. Needs a CUDA device.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()
os.environ["OMP_NUM_THREADS"] = "1"  # as port_bench/run.py

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds also read the control and the fault")
    ap.add_argument("--float32", action="store_true",
                    help="a witness: the program in float32 with the float32 front end")
    args = ap.parse_args(argv)

    import torch

    from port_bench import cells, spec

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if args.float32:
        deps = cell.config["departures"]
        deps["GPU.DSP_PRECISION"] = {"value": "HIGHEST", "why": "witness"}
        deps["GPU.COMPUTE_DTYPE"] = {"value": "float32", "why": "witness"}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out, run = cells.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t0,
                                  controls=i < args.control_seeds)
        line = {"workload": cell.name, "float32": args.float32, "seed": seed,
                "program": out["checks"],
                **out["info"], "steps": len(run.window_calls), "phases": run.phases,
                "seconds": time.perf_counter() - t0,
                "device": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
