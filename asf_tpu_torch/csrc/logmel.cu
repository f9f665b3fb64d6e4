// Fused log-mel front end for Hopper (sm_90a): waveform -> log-mel in one pass.
//
// Replaces the two Pallas TPU kernels on the main path of asf_tpu:
//   logmel_f32  <- asf_tpu/ops/logmel_pallas.py:_partial_mel (_kernel), plus the
//                  caller's sum over frequency tiles and log (:458-464);
//   logmel_bf16 <- asf_tpu/ops/logmel_pallas.py:_resident_logmel (_kernel_resident).
//
// Function (per sample b, frame t, mel m), with x the un-padded waveform:
//   frame[t][c] = x[t*hop + off + c]   (zero outside [0, S)), c < ksup,
//                 off = s0a - n_fft/2: the librosa centre padding and the
//                 window-support trim in one index, no frame tensor in memory;
//   re[k] = sum_c frame[c] * w_cos[c][k],  im[k] = sum_c frame[c] * w_sin[c][k];
//   mag[k] = sqrt(re^2 + im^2)          (rounded to bf16 in the bf16 kernel,
//                                         as _kernel_resident does at :221);
//   out[b][t][m] = log(sum_k mag[k] * mel[k][m] + eps).
//
// What bounds it on the H100: operations. At the flagship geometry a frame
// costs 2*2*256*1025 (DFT) + 2*1025*128 (mel) ~ 1.31 MFLOP against ~1 KB of
// waveform read and 512 B of output written: ~870 FLOP per byte, far above
// the card's balance point (~20 FLOP/byte for float32 outside the tensor
// cores, ~295 for bf16 in them).
// What this design does about it (simple and right first; wgmma, TMA and
// tuning are later work):
//   * one block owns one sample and a tile of kFrames frames; the frame tile
//     is read once from device memory into shared memory and reused by all
//     1152 frequencies, so device-memory traffic is the waveform once plus
//     the weights (which stay in L2: 2.4 MB f32 / 1.2 MB bf16);
//   * register tiling: each thread keeps 8 frames x 2 frequencies of re and
//     im (32 accumulators), so one pair of weight loads feeds 16 FMAs and
//     the frame reads are broadcast 16-byte shared-memory loads;
//   * the mel product accumulates (kFrames x 128 mels) in registers across
//     frequency chunks: the (nk, rows, m) partial stack of the TPU kernel
//     never exists, and the log is the epilogue;
//   * IEEE float32 FMA throughout (no TF32, no fast math), float32
//     accumulation in the bf16 kernel too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 32;   // frames per block
constexpr int kChunk = 128;   // frequencies per chunk; kf must be a multiple
constexpr int kMels = 128;    // mel columns of the (kf, kMels) mel matrix
constexpr int kThreads = 256;
constexpr int kRow = kFrames + 4;  // shared-memory row stride in floats (16-byte aligned rows)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The magnitude enters the mel product in the weights' type.
template <typename T>
__device__ __forceinline__ float mag_in(float v);
template <>
__device__ __forceinline__ float mag_in<float>(float v) { return v; }
template <>
__device__ __forceinline__ float mag_in<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const T* __restrict__ wave, const T* __restrict__ w_cos,
              const T* __restrict__ w_sin, const T* __restrict__ mel,
              float* __restrict__ out, int S, int n_frames, int hop, int off,
              int ksup, int kf, int n_mels, float eps) {
  extern __shared__ float4 smem4[];
  float* frames = reinterpret_cast<float*>(smem4);  // [ksup][kRow], tap-major
  float* mag = frames + ksup * kRow;                // [kChunk][kRow], frequency-major

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const T* x = wave + static_cast<long long>(b) * S;

  // Frame tile straight from the waveform with row stride hop.
  for (int i = tid; i < kFrames * ksup; i += kThreads) {
    const int f = i / ksup;
    const int c = i - f * ksup;
    const long long idx = static_cast<long long>(t0 + f) * hop + off + c;
    frames[c * kRow + f] = (idx >= 0 && idx < S) ? to_float(x[idx]) : 0.0f;
  }
  __syncthreads();

  const int dk = tid % 64;   // DFT: frequencies dk and dk + 64 of the chunk
  const int df = tid / 64;   // DFT: frames df*8 .. df*8+7
  const int mm = tid % kMels;  // mel column
  const int mf = tid / kMels;  // mel: frames mf*16 .. mf*16+15

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < kf; k0 += kChunk) {
    float re0[8], re1[8], im0[8], im1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) re0[j] = re1[j] = im0[j] = im1[j] = 0.0f;

    const T* wc = w_cos + k0 + dk;
    const T* ws = w_sin + k0 + dk;
#pragma unroll 4
    for (int c = 0; c < ksup; ++c) {
      const long long row = static_cast<long long>(c) * kf;
      const float c0 = to_float(wc[row]);
      const float c1 = to_float(wc[row + 64]);
      const float s0 = to_float(ws[row]);
      const float s1 = to_float(ws[row + 64]);
      const float4* fr = reinterpret_cast<const float4*>(frames + c * kRow + df * 8);
      const float4 a = fr[0];
      const float4 q = fr[1];
      const float v[8] = {a.x, a.y, a.z, a.w, q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        re0[j] = fmaf(v[j], c0, re0[j]);
        re1[j] = fmaf(v[j], c1, re1[j]);
        im0[j] = fmaf(v[j], s0, im0[j]);
        im1[j] = fmaf(v[j], s1, im1[j]);
      }
    }

    __syncthreads();  // the previous chunk's mel product has read mag
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mag[dk * kRow + df * 8 + j] =
          mag_in<T>(sqrtf(re0[j] * re0[j] + im0[j] * im0[j]));
      mag[(dk + 64) * kRow + df * 8 + j] =
          mag_in<T>(sqrtf(re1[j] * re1[j] + im1[j] * im1[j]));
    }
    __syncthreads();

    const T* mw = mel + static_cast<long long>(k0) * kMels + mm;
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      const float w = to_float(mw[k * kMels]);
      const float4* mg = reinterpret_cast<const float4*>(mag + k * kRow + mf * 16);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = mg[q];
        acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
      }
    }
  }

  if (mm < n_mels) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int t = t0 + mf * 16 + j;
      if (t < n_frames) {
        out[(static_cast<long long>(b) * n_frames + t) * n_mels + mm] = logf(acc[j] + eps);
      }
    }
  }
}

template <typename T>
int launch(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
           void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
           int kf, int n_mels, float eps, void* stream) {
  const size_t smem = static_cast<size_t>(ksup + kChunk) * kRow * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {  // e.g. a support too wide for shared memory
    cudaGetLastError();       // clear it, so that no later launch reports it
    return static_cast<int>(err);
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  logmel_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wave), static_cast<const T*>(w_cos),
      static_cast<const T*>(w_sin), static_cast<const T*>(mel),
      static_cast<float*>(out), S, n_frames, hop, off, ksup, kf, n_mels, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shapes: wave (batch, S); w_cos, w_sin (ksup, kf); mel (kf, 128); out
// (batch, n_frames, n_mels) float32; all contiguous on the current device.
// Returns the cudaError_t of the launch (0 on success).
int logmel_f32(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
               void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
               int kf, int n_mels, float eps, void* stream) {
  return launch<float>(wave, w_cos, w_sin, mel, out, batch, S, n_frames, hop, off, ksup,
                       kf, n_mels, eps, stream);
}

// The same with bf16 wave, w_cos, w_sin and mel; out stays float32.
int logmel_bf16(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
                void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
                int kf, int n_mels, float eps, void* stream) {
  return launch<__nv_bfloat16>(wave, w_cos, w_sin, mel, out, batch, S, n_frames, hop, off,
                               ksup, kf, n_mels, eps, stream);
}

const char* logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
