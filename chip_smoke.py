#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Four phases, each of which raises on a
failed check (the script then exits non-zero and prints no result):

1. Device and build: needs a CUDA device; prints the card's name and power
   limit as ``nvidia-smi`` gives them, builds the CUDA kernels from
   ``asf_tpu_torch/csrc`` with ``nvcc`` and prints the build time.
2. Kernels: each log-mel kernel against its plain PyTorch version at the
   flagship geometry (24 kHz, n_fft 2048, 256 frames, 128 mels), batch 8 and
   128, the last record short (n_valid = S/3). Median times over CUDA-event
   timed launches, and the bound: the larger of the operations over the
   card's peak rate for their type and the bytes over its memory rate.
3. Slice: the port's entry point serves 4 batches of 8 clips with the
   float32 front end and 3 batches of 128 with the bf16 one through the
   VGG-Sound SlowFast-R50 at full width and depth (weights from a seed).
   The launch counts are zeroed just before and read just after; the
   probabilities must be finite rows that sum to 1 and agree with the same
   model behind the plain front end. Then clips/s at batch 128.
4. One ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Dense peaks by card (NVIDIA's data sheets; rates at the full power limit):
# float32 outside the tensor cores, bf16 in them, device memory bytes/s.
PEAKS = {
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100": (67e12, 989e12, 3.35e12),  # SXM
}

# The TPU kernel each CUDA kernel replaces (function definition).
REPLACES = {
    "logmel_f32": "asf_tpu/ops/logmel_pallas.py:284",  # _partial_mel (+ sum and log, :458-464)
    "logmel_bf16": "asf_tpu/ops/logmel_pallas.py:232",  # _resident_logmel
}
F32_TOL = 1e-4  # log domain, max abs: float32 FMA in another summation order
# max and mean abs: the same bf16 roundings in another order. A magnitude
# whose bf16 rounding flips moves its mel bin by at most log(1 + 2**-8) ~ 3.9e-3;
# such flips are rare, so the mean stays near 1e-8.
BF16_TOL = (1e-2, 1e-6)
PROB_TOL = 1e-3  # probabilities, kernel front end vs plain front end


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def peaks(name: str):
    """(float32, bf16, bytes/s) peaks of the card; the H100 SXM's for an unknown name."""
    return next((v for k, v in PEAKS.items() if k in name), PEAKS["H100"])


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    check((ROOT / "asf_tpu_torch" / "csrc").is_dir(),
          f"{ROOT} is not a checkout of the repository (asf_tpu_torch/ is missing)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    sys.path.insert(0, str(ROOT))
    from asf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build("logmel")
    print(f"[build] logmel {'built' if log is not None else 'already built'} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}", flush=True)
    for line in (log or "").splitlines():
        if "registers" in line or "spill" in line or "bytes stack" in line:
            print(f"[build] {line.strip()}")


def phase_kernels(card: str) -> dict:
    from asf_tpu_torch.dsp.logmel import LogMelParams
    from asf_tpu_torch.entry import flagship_cfg
    from asf_tpu_torch.ops import logmel as ops
    from asf_tpu_torch.utils.torch_setup import disable_tf32

    disable_tf32()
    f32_peak, bf16_peak, mem_rate = peaks(card)
    results = {}
    for precision, name in (("HIGHEST", "logmel_f32"), ("BFLOAT16", "logmel_bf16")):
        cfg = flagship_cfg()
        cfg.GPU.DSP_PRECISION = precision
        p = LogMelParams(cfg, "cuda")
        kernel, plain = getattr(ops, name), getattr(ops, f"{name}_plain")
        results[name] = {"max_abs_err": 0.0}
        for batch in (8, 128):
            wave = np.random.default_rng(batch).standard_normal((batch, p.clip_samples))
            wave[-1, p.clip_samples // 3 :] = 0.0  # a short record, zero-padded by its host
            wave = torch.from_numpy((wave * 0.1).astype(np.float32)).cuda().to(p.dtype)
            geo = p.geometry(p.clip_samples)
            args = (wave, p.w_cos, p.w_sin, p.mel_w)
            got = kernel(*args, **geo)
            want = plain(*args, **geo)
            torch.cuda.synchronize()
            check(got.shape == (batch, 256, 128), f"{name} shape {tuple(got.shape)}")
            check(bool(torch.isfinite(got).all()), f"{name} gave non-finite values")
            err = (got - want).abs()
            max_err, mean_err = err.max().item(), err.mean().item()
            if p.fast:
                check(max_err <= BF16_TOL[0] and mean_err <= BF16_TOL[1],
                      f"{name} B={batch}: max {max_err} mean {mean_err} > {BF16_TOL}")
                # The same bf16 inputs without the magnitude rounding (:221):
                # a kernel that skips that rounding lands nearer this.
                unrounded = ops.logmel_f32_plain(*args, **geo)
                miss = (got - unrounded).abs().mean().item()
                check(mean_err < miss, f"{name} B={batch}: mean {mean_err} from the plain "
                      f"version, {miss} from it without the magnitude rounding")
                print(f"[kernel] {name} B={batch}: mean abs {miss:.3g} from the plain version "
                      f"without the magnitude rounding", flush=True)
            else:
                check(max_err <= F32_TOL, f"{name} B={batch}: max {max_err} > {F32_TOL}")
            ms = cuda_ms(lambda: kernel(*args, **geo), reps=25)
            plain_ms = cuda_ms(lambda: plain(*args, **geo), reps=20)
            # Work the function must do: the DFT over the aligned support for
            # 1 + n_fft/2 frequencies, the mel product; each input read once.
            frames = batch * geo["n_frames"]
            flops = frames * (2 * 2 * p.ksup * p.n_freqs + 2 * p.n_freqs * p.n_mels)
            nbytes = (sum(t.numel() * t.element_size() for t in args)
                      + frames * p.n_mels * 4)
            peak = bf16_peak if p.fast else f32_peak
            op_ms, byte_ms = flops / peak * 1e3, nbytes / mem_rate * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(op_ms, byte_ms),
                       bound_by="operations" if op_ms >= byte_ms else "bytes",
                       gflop=flops / 1e9, mbytes=nbytes / 1e6)
            print(f"[kernel] {name} B={batch}: max_abs_err {max_err:.3g} mean {mean_err:.3g} | "
                  f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']}; {flops / ms / 1e9:.2f} TFLOP/s) | {card}", flush=True)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], max_err)
            results[name][batch] = row
    return results


def phase_slice(card: str) -> tuple[dict, dict]:
    from asf_tpu_torch.dsp.logmel import edge_pad
    from asf_tpu_torch.engine.pipeline import pack_pathways
    from asf_tpu_torch.entry import entry
    from asf_tpu_torch.ops import logmel as ops

    t0 = time.perf_counter()
    serve8, (model8, _, _) = entry(batch=8, dsp_precision="HIGHEST")
    serve128, (model128, _, _) = entry(batch=128, dsp_precision="BFLOAT16")
    torch.cuda.synchronize()
    print(f"[slice] two SlowFast-R50 models built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model8.parameters()) / 1e6:.2f} M parameters)", flush=True)

    s = serve8.pipeline.params.clip_samples
    rng = np.random.default_rng(1234)

    def request(batch, int16):
        n_valid = rng.integers(s // 4, s + 1, batch).astype(np.int32)
        n_valid[0] = s
        wave = rng.standard_normal((batch, s)) * 0.1
        wave[np.arange(s)[None, :] >= n_valid[:, None]] = 0.0  # hosts zero-pad short records
        wave = (wave * 32768).astype(np.int16) if int16 else wave.astype(np.float32)
        return torch.from_numpy(wave).cuda(), torch.from_numpy(n_valid).cuda()

    requests = [(serve8, model8, request(8, int16=i == 3)) for i in range(4)]
    requests += [(serve128, model128, request(128, int16=i == 2)) for i in range(3)]
    torch.cuda.synchronize()

    ops.logmel_f32.launches = 0
    ops.logmel_bf16.launches = 0
    outputs = [serve(model, *req) for serve, model, req in requests]
    torch.cuda.synchronize()
    launches = {"logmel_f32": ops.logmel_f32.launches, "logmel_bf16": ops.logmel_bf16.launches}
    print(f"[slice] launches on the main path: {launches}", flush=True)
    check(launches == {"logmel_f32": 4, "logmel_bf16": 3},
          f"expected one launch per batch (4 float32, 3 bf16), got {launches}")

    for (serve, _, (wave, _)), probs in zip(requests, outputs):
        check(probs.shape == (wave.shape[0], 309), f"probabilities of shape {tuple(probs.shape)}")
        check(bool(torch.isfinite(probs).all()), "non-finite probabilities")
        sums = probs.sum(dim=1)
        check(bool(((sums - 1).abs() <= 1e-3).all()), f"rows sum to {sums.min()}..{sums.max()}")

    # The same models behind the plain front end, for the first and last request.
    diffs = {}
    for idx, plain in ((0, ops.logmel_f32_plain), (len(requests) - 1, ops.logmel_bf16_plain)):
        serve, model, (wave, n_valid) = requests[idx]
        pipe = serve.pipeline
        p, cfg = pipe.params, pipe.cfg
        with torch.inference_mode():
            x = wave.float() / 32768.0 if wave.dtype == torch.int16 else wave
            log_mel = plain(x.to(p.dtype).contiguous(), p.w_cos, p.w_sin, p.mel_w,
                            **p.geometry(x.shape[1]))
            spec = edge_pad(log_mel, n_valid, p.hop, cfg.AUDIO_DATA.NUM_FRAMES)
            want = model(pack_pathways(cfg, spec))
        diff = (outputs[idx] - want).abs().max().item()
        diffs[plain.__name__] = diff
        check(diff <= PROB_TOL, f"{plain.__name__} front end: probabilities differ by {diff}")
    print(f"[slice] max abs difference of the probabilities from the plain front end: {diffs}",
          flush=True)

    timing = {}
    for label, (serve, model, (wave, n_valid)) in (("B=8 float32 DSP", requests[0]),
                                                   ("B=128 bf16 DSP", requests[-1])):
        ms = cuda_ms(lambda: serve(model, wave, n_valid), reps=10, warmup=2)
        timing[label] = dict(ms=ms, clips_per_s=wave.shape[0] / ms * 1e3)
        print(f"[slice] {label}: {ms:.3f} ms per batch, {wave.shape[0] / ms * 1e3:.1f} clips/s "
              f"(bf16 SlowFast-R50 trunk) | {card}", flush=True)
    print(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, timing


def main() -> None:
    phase_device()
    card = torch.cuda.get_device_name(0)
    kernels = phase_kernels(card)
    launches, _ = phase_slice(card)
    line = []
    for name, res in kernels.items():
        row = res[128]
        line.append({
            "name": name, "route": "cuda", "source": "asf_tpu_torch/csrc/logmel.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
            "batch": 128, "ms_b8": res[8]["ms"], "plain_ms_b8": res[8]["plain_ms"],
            "bound_ms_b8": res[8]["bound_ms"],
        })
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
