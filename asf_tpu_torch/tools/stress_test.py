"""Burn-in of the cards: chained bf16 matmuls, TFLOP/s at each interval.

    python -m asf_tpu_torch.tools.stress_test -n 8192 [--seconds 60] [--device cpu]

Counterpart of ``asf_tpu/tools/stress_test.py``: on every local CUDA device
(or the CPU with ``--device cpu``) a chain of ``chain`` steps ``x <-
tanh(x @ b) * 1e-3 + a * 1e-6`` of (n, n) bf16 matrices, 2 n^3 operations
a step, run again and again for ``seconds``; after each chain the host
reads the sum of every device's result, which waits for its work, and the
rate of that interval is logged. The product is a library one
(``torch.matmul``): the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger(__name__)


def stress_test(n: int = 8192, seconds: float = 60.0, chain: int = 100, device=None) -> float:
    """Runs for ``seconds``; returns the last interval's TFLOP/s a device."""
    if device is not None and torch.device(device).type == "cpu":
        devices = [torch.device("cpu")]
    else:
        from ..utils.torch_setup import resolve_device

        resolve_device(device)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    logger.info("Running stress test on %d device(s): %s", len(devices), devices)

    def burn(a, b):
        x = a
        for _ in range(chain):
            x = torch.tanh(x @ b) * 1e-3 + a * 1e-6
        return x, x.float().sum()

    rng = np.random.default_rng(0)
    mats = [tuple(torch.from_numpy(rng.standard_normal((n, n), np.float32)).to(d, torch.bfloat16)
                  for _ in range(2)) for d in devices]

    def step(pairs):
        out, checks = [], []
        for a, b in pairs:
            a2, s = burn(a, b)
            out.append((a2, b))
            checks.append(s)
        for s in checks:
            float(s)  # the host read waits for the device's chain
        return out

    mats = step(mats)  # warm-up
    flops_per_call = 2.0 * n * n * n * chain
    rate = 0.0
    t_end = time.time() + seconds
    while time.time() < t_end:
        t0 = time.perf_counter()
        mats = step(mats)
        rate = flops_per_call / (time.perf_counter() - t0) / 1e12
        logger.info("sustained %.1f TFLOP/s per device (%d devices)", rate, len(devices))
    return rate


if __name__ == "__main__":
    from ..utils.logging import setup_logging

    setup_logging(None)
    parser = argparse.ArgumentParser()
    parser.add_argument("-n", type=int, default=8192, help="Matrix size")
    parser.add_argument("--seconds", type=float, default=60.0)
    parser.add_argument("--device", default=None,
                        help="The local CUDA devices unless 'cpu'")
    args = parser.parse_args()
    stress_test(args.n, args.seconds, device=args.device)
