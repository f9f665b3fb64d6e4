"""The float32 FMA rate the card sustains, fed from registers or from shared memory.

    python -m asf_tpu_torch.tools.fma_probe

A yardstick for ``logmel_f32``'s inner loops: one block of 256 or 512
threads on each SM, each thread a register tile of 8 x 8 float32 sums. The
"register" probe feeds the FMAs from registers; the "shared" probe loads its
operands per step as the kernel's DFT loop does (four broadcast 16-byte
shared-memory loads for 64 FMAs). Prints TFLOP/s for each, and the SM clock
and power ``nvidia-smi`` reads while it runs. Needs a GPU and ``nvcc``;
builds into ``build/kernels/``.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import time

import torch

from ..ops import _build

SOURCE = r"""
#include <cuda_runtime.h>
template <bool kShared>
__global__ void probe(float* out, int iters) {
  extern __shared__ float4 sm[];
  float* s = reinterpret_cast<float*>(sm);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int i = tid; i < 8448; i += blockDim.x) s[i] = i * 1e-7f;
  __syncthreads();
  const int fg = warp / 2 % 4 * 4 + lane / 8, g = warp % 2 * 8 + lane % 8;
  float acc[8][8], av[8], wv[8];
  for (int i = 0; i < 8; ++i) {
    av[i] = tid * 1e-3f + i;
    wv[i] = i * 0.5f;
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      if (kShared) {
        const float4 a0 = *reinterpret_cast<const float4*>(s + c * 132 + 4 * fg);
        const float4 a1 = *reinterpret_cast<const float4*>(s + c * 132 + 64 + 4 * fg);
        const float4 w0 = *reinterpret_cast<const float4*>(s + 4224 + c * 64 + 4 * g);
        const float4 w1 = *reinterpret_cast<const float4*>(s + 6272 + c * 64 + 4 * g);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
        wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
        wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
      } else {
        av[c % 8] += 1e-9f;  // keeps the operands live without loads
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
  float t = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) t += acc[i][j];
  out[blockIdx.x * blockDim.x + tid] = t;
}
// 150,000 bytes of shared memory hold each SM to one block.
extern "C" int run_probe(int shared, float* out, int blocks, int threads, int iters) {
  auto k = shared ? probe<true> : probe<false>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 150000);
  k<<<blocks, threads, 150000>>>(out, iters);
  return cudaGetLastError();
}
"""
ITERS = 2000
REPS = 200  # about a second a probe, for nvidia-smi's samples


def _library() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = _build.BUILD_DIR / "fma_probe.cu", _build.BUILD_DIR / "fma_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.run_probe.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
    return dll


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    card = _smi("name,power.limit").splitlines()[0]
    lib = _library()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(n_sms * 512, device="cuda")
    for shared in (0, 1):
        for threads in (256, 512):
            def run():
                assert lib.run_probe(shared, out.data_ptr(), n_sms, threads, ITERS) == 0

            run()
            torch.cuda.synchronize()
            samples, stop = [], threading.Event()

            def sample():
                while not stop.is_set():
                    samples.append(_smi("clocks.sm,power.draw"))
                    time.sleep(0.2)

            watcher = threading.Thread(target=sample)
            watcher.start()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                run()
            end.record()
            end.synchronize()
            stop.set()
            watcher.join()
            ms = start.elapsed_time(end) / REPS
            flops = n_sms * threads * ITERS * 32 * 64 * 2
            print(f"[probe] {'shared-fed' if shared else 'register'} FMA, {n_sms} blocks x "
                  f"{threads} threads: {flops / ms / 1e9:.1f} TFLOP/s; clocks.sm, power.draw "
                  f"{sorted(set(samples))} | {card}", flush=True)


if __name__ == "__main__":
    main()
