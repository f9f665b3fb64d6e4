"""The benchmark of ``asf_tpu_torch`` on one NVIDIA GPU: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root and the cell's files under
``port_bench/`` (``spec.py``), makes the cell's split and weights from the
seed, builds the port as ``train(cfg)`` / ``test(cfg)`` do, warms up, runs
the window for ``--seconds`` (``cells.py``), then judges what the window's
loop produced against the plain reference (``reference/``) and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and ``checks``, each number compared beside its
limit, which also end standard error.

Exits with 2, printing no result, when CUDA is absent or the cell asks for
more cards than there are; with 3 when ``jax``, ``jaxlib``, ``flax``,
``optax`` or ``asf_tpu`` is loaded in this process once the window has
closed. The environment's ``BENCH_RUN`` is not read. The port's kernel
cache is its own ``build/kernels/`` inside the checkout.
"""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

# One intra-op CPU thread, as torchrun gives each process: the card does the
# math, and idle OpenMP workers spinning beside the dispatching thread made
# the host-paced step vary from run to run.
os.environ["OMP_NUM_THREADS"] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "asf_tpu")


def loaded_forbidden() -> list:
    """Top-level names of ``sys.modules`` that are JAX's or the JAX package's,
    compared whole (``asf_tpu_torch`` is not ``asf_tpu``)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def end_to_end(cell, out: dict, run) -> dict:
    import numpy as np

    rate = out["samples"] / run.window_s if run.window_s > 0 else 0.0
    values = {"setup_s": out["setup_s"],
              "train_samples_per_s": rate, "test_views_per_s": rate,
              "step_p95_ms": float(np.percentile(run.gaps_s, 95)) * 1e3 if run.gaps_s else None}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


def thirds(run) -> list:
    """Each third of the window by the card's clock (the steps that ended in
    it): samples a second, the median and the longest step in ms; whether a
    run's pace drifts within the window, steadily or by stalls, or only from
    process to process."""
    import numpy as np

    if not run.gaps_s:
        return []
    gaps = np.asarray(run.gaps_s)
    ends = np.cumsum(gaps)
    rows = np.asarray([run.spans.calls[i][3 if run.kind == "train" else 2]
                       for i in run.window_calls], float)
    edges = np.linspace(0.0, ends[-1], 4)
    out = []
    for a, b in zip(edges, edges[1:]):
        sel = (ends > a) & (ends <= b)
        out.append([float(rows[sel].sum() / (b - a)), float(np.median(gaps[sel]) * 1e3),
                    float(gaps[sel].max() * 1e3)] if sel.any() else [0.0, 0.0, 0.0])
    return out


def per_layer(cell, run) -> dict:
    from port_bench import spec

    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def checks_of(cell, values: dict) -> dict:
    """The numbers the cell's limits name, each beside its limit."""
    return {k: {"value": float(values[k]), "limit": float(lim)} for k, lim in cell.limits.items()}


def run_once(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             faults=None) -> tuple[dict, list]:
    """One run of ``cell`` on ``device``: the result's object and the lines
    for standard error, the numbers compared last."""
    import torch

    from port_bench import cells
    from port_bench import trace as trace_mod

    out, run = cells.run_cell(cell, seed, seconds, trace, device, t_start, faults=faults)
    checks = checks_of(cell, out["checks"])
    correct = (out["error"] is None and out["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": cells.device_name(device), "count": 1,
           "memory_peak_bytes": int(out["peak"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if trace:
        metrics = per_layer(cell, run)
        if run.trace is not None:
            dev.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    else:
        metrics = end_to_end(cell, out, run)
    result.update(metrics=metrics, device=dev)
    if trace and run.trace is not None:
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["checks"] = checks
    lines = []
    if out["error"] is not None:
        lines.append(f"[port_bench] the window failed: {out['error']!r}")
    lines.append(f"[port_bench] {cell.name} seed {seed}: {len(run.window_calls)} steps in "
                 f"{run.window_s:.3f} s, {out['samples']} samples, set-up {out['setup_s']:.3f} "
                 f"s, {run.bytes_written / 2**30:.3f} GiB written")
    lines.append(f"[port_bench] set-up phases (s): {json.dumps(run.phases)}")
    lines.append("[port_bench] thirds of the window (samples/s, median and longest step ms): "
                 + json.dumps(thirds(run)))
    info = {**{k: v for k, v in out["checks"].items() if k not in checks}, **out["info"]}
    lines.append(f"[port_bench] beside the checks: {json.dumps(info)}")
    if run.trace is not None:
        lines.append(f"[port_bench] trace: {run.trace['steps']} steps, "
                     f"{run.trace['device_events']} device events, log-mel launches seen "
                     f"{len(run.trace['logmel'])} of {run.trace['steps']}")
    lines += [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[port_bench] needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = run_once(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    lines.insert(0, f"[port_bench] card (name, power limit): {card_line()}")
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"[port_bench] loaded in this process: {forbidden}", file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
