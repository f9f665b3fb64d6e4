// Fused log-mel front end for Hopper (sm_90a): waveform -> log-mel in one pass.
//
// Replaces the three Pallas TPU kernels of asf_tpu/ops/logmel_pallas.py:
//   logmel_f32       <- _partial_mel (_kernel), plus the caller's sum over
//                       frequency tiles and log (:458-464);
//   logmel_bf16      <- _resident_logmel (_kernel_resident);
//   logmel_bf16_wide <- _hopblock_logmel (_kernel_hopblock), the bf16 path for
//                       wide window supports (hop <= 128, support > 512 taps).
//
// Function (per sample b, frame t, mel m), with x the un-padded waveform:
//   frame[t][c] = x[t*hop + off + c]   (zero outside [0, S)), c < ksup,
//                 off = s0a - n_fft/2: the librosa centre padding and the
//                 window-support trim in one index, no frame tensor in memory;
//   re[k] = sum_c frame[c] * w_cos[c][k],  im[k] = sum_c frame[c] * w_sin[c][k];
//   mag[k] = sqrt(re^2 + im^2)          (rounded to bf16 in the bf16 kernels,
//                                         as _kernel_resident does at :221 and
//                                         _kernel_hopblock at :143);
//   out[b][t][m] = log(sum_k mag[k] * mel[k][m] + eps).
//
// What bounds them on the H100: operations. At the flagship geometry a frame
// costs 2*2*256*1025 (DFT) + 2*1025*128 (mel) ~ 1.31 MFLOP against ~1 KB of
// waveform read and 512 B of output written: ~870 FLOP per byte, far above
// the card's balance point (~20 FLOP/byte for float32 outside the tensor
// cores, ~295 for bf16 in them). A 2048-tap support costs 8.66 MFLOP a frame.
// What the designs do about it (simple and right first; wgmma, TMA and tuning
// are later work):
//   * one block owns one sample and a tile of kFrames frames, and loops over
//     the frequency chunks itself; the mel product accumulates (kFrames x 128
//     mels) in registers across chunks, so the (nk, rows, m) partial stack of
//     the TPU kernel never exists, and the log is the epilogue;
//   * device-memory traffic is the waveform once plus the weights, which stay
//     in L2 (2.4 MB f32 / 1.2 MB bf16 at 256 taps, 9.4 MB bf16 at 2048);
//   * IEEE float32 FMA throughout (no TF32, no fast math), float32
//     accumulation in the bf16 kernels too.
// logmel_kernel<T> (logmel_f32, logmel_bf16) keeps a tap-major frame tile in
// shared memory, kTapChunk taps at a time: each thread keeps 8 frames x 2
// frequencies of re and im (32 accumulators) in registers across tap chunks,
// one pair of weight loads feeds 16 FMAs, and the frame reads are broadcast
// 16-byte shared-memory loads. A support of at most kTapChunk taps (256 at
// the flagship geometry) is staged once; a wider one is staged chunk by chunk
// for every frequency chunk, so the tile never grows with the support.
// logmel_wide_kernel (logmel_bf16_wide) is K3's counterpart. At a wide
// support the frames of a tile overlap ~ksup/hop (~17x) times, so it stages
// once the contiguous waveform span its frames cover, (kFrames-1)*hop + ksup
// samples (23 KB in float32 at hop 120 and 2048 taps, against 295 KB for a
// tap-major frame tile), and reads frame f, tap c as span[f*hop + c]. Each
// warp owns 4 frames and all 128 frequencies of a chunk, 4 adjacent ones per
// lane: the 32 lanes read the same span word (a broadcast: no bank conflict,
// whatever the hop) and 8 adjacent bytes each of a weight row (one 256-byte
// coalesced row per warp). K3's 128-lane padding of every hop (2304
// contraction rows for 2048 taps) is a TPU layout and does not exist here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kFrames = 32;     // frames per block
constexpr int kChunk = 128;     // frequencies per chunk; kf must be a multiple
constexpr int kMels = 128;      // mel columns of the (kf, kMels) mel matrix
constexpr int kThreads = 256;
constexpr int kRow = kFrames + 4;  // shared-memory row stride in floats (16-byte aligned rows)
constexpr int kTapChunk = 256;     // taps of the frame tile of logmel_kernel

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

// Adds the mel product of one frequency chunk to acc. mag is [kChunk][kRow],
// frequency-major; thread tid owns mel column tid % 128 of frames
// (tid / 128) * 16 .. +15, so a warp's magnitude reads are broadcasts.
template <typename T>
__device__ __forceinline__ void mel_chunk(const T* __restrict__ mel, int k0,
                                          const float* mag, int tid, float acc[16]) {
  const T* mw = mel + static_cast<long long>(k0) * kMels + tid % kMels;
  const int mf = tid / kMels;
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

__device__ __forceinline__ void store_log(float* __restrict__ out, const float acc[16], int b,
                                          int t0, int n_frames, int n_mels, float eps, int tid) {
  const int mm = tid % kMels;
  const int mf = tid / kMels;
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

// Taps c0 .. c0+nc of the block's frames into the tap-major tile [nc][kRow].
template <typename T>
__device__ __forceinline__ void stage_taps(float* frames, const T* __restrict__ x, int S,
                                           int hop, int off, int t0, int c0, int nc, int tid) {
  for (int i = tid; i < kFrames * nc; i += kThreads) {
    const int f = i / nc;
    const int c = i - f * nc;
    const long long idx = static_cast<long long>(t0 + f) * hop + off + c0 + c;
    frames[c * kRow + f] = (idx >= 0 && idx < S) ? to_float(x[idx]) : 0.0f;
  }
}

// At least 3 blocks of 256 threads per SM, so at most 85 registers a thread
// (80 used, a few bytes spilled). Without the bound the tap-chunk loop takes
// 82 (bf16) and 92 (float32) registers, the SM holds 2 blocks, and at B = 128
// the bf16 kernel ran 14 % slower than the single-tile kernel it replaced.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
logmel_kernel(const T* __restrict__ wave, const T* __restrict__ w_cos,
              const T* __restrict__ w_sin, const T* __restrict__ mel,
              float* __restrict__ out, int S, int n_frames, int hop, int off,
              int ksup, int kf, int n_mels, float eps) {
  extern __shared__ float4 smem4[];
  const int tile = min(ksup, kTapChunk);
  float* frames = reinterpret_cast<float*>(smem4);  // [tile][kRow], tap-major
  float* mag = frames + tile * kRow;                // [kChunk][kRow], frequency-major

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const T* x = wave + static_cast<long long>(b) * S;
  const bool resident = ksup <= kTapChunk;  // the whole support fits the tile

  if (resident) {
    stage_taps(frames, x, S, hop, off, t0, 0, ksup, tid);
    __syncthreads();
  }

  const int dk = tid % 64;  // DFT: frequencies dk and dk + 64 of the chunk
  const int df = tid / 64;  // DFT: frames df*8 .. df*8+7

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < kf; k0 += kChunk) {
    float re0[8], re1[8], im0[8], im1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) re0[j] = re1[j] = im0[j] = im1[j] = 0.0f;

    for (int c0 = 0; c0 < ksup; c0 += kTapChunk) {
      const int nc = min(kTapChunk, ksup - c0);
      if (!resident) {
        __syncthreads();  // every thread is done with the previous tap chunk
        stage_taps(frames, x, S, hop, off, t0, c0, nc, tid);
        __syncthreads();
      }
      const T* wc = w_cos + static_cast<long long>(c0) * kf + k0 + dk;
      const T* ws = w_sin + static_cast<long long>(c0) * kf + k0 + dk;
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const long long row = static_cast<long long>(c) * kf;
        const float c0w = to_float(wc[row]);
        const float c1w = to_float(wc[row + 64]);
        const float s0w = to_float(ws[row]);
        const float s1w = to_float(ws[row + 64]);
        const float4* fr = reinterpret_cast<const float4*>(frames + c * kRow + df * 8);
        const float4 a = fr[0];
        const float4 q = fr[1];
        const float v[8] = {a.x, a.y, a.z, a.w, q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          re0[j] = fmaf(v[j], c0w, re0[j]);
          re1[j] = fmaf(v[j], c1w, re1[j]);
          im0[j] = fmaf(v[j], s0w, im0[j]);
          im1[j] = fmaf(v[j], s1w, im1[j]);
        }
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
    mel_chunk(mel, k0, mag, tid, acc);
  }
  store_log(out, acc, b, t0, n_frames, n_mels, eps, tid);
}

// Four bf16 (8 bytes) -> float: a bf16 is the top half of a float32.
__device__ __forceinline__ void bf16x4(uint2 u, float f[4]) {
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

__host__ __device__ __forceinline__ int span_floats(int hop, int ksup) {
  return ((kFrames - 1) * hop + ksup + 3) / 4 * 4;  // rounded up: mag stays 16-byte aligned
}

__global__ void __launch_bounds__(kThreads)
logmel_wide_kernel(const __nv_bfloat16* __restrict__ wave,
                   const __nv_bfloat16* __restrict__ w_cos,
                   const __nv_bfloat16* __restrict__ w_sin,
                   const __nv_bfloat16* __restrict__ mel, float* __restrict__ out, int S,
                   int n_frames, int hop, int off, int ksup, int kf, int n_mels, float eps) {
  extern __shared__ float4 smem4[];
  float* span = reinterpret_cast<float*>(smem4);  // the waveform under the block's frames
  float* mag = span + span_floats(hop, ksup);     // [kChunk][kRow], frequency-major

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const __nv_bfloat16* x = wave + static_cast<long long>(b) * S;

  const int n_span = (kFrames - 1) * hop + ksup;
  const long long base = static_cast<long long>(t0) * hop + off;
  for (int i = tid; i < n_span; i += kThreads) {
    const long long idx = base + i;
    span[i] = (idx >= 0 && idx < S) ? __bfloat162float(x[idx]) : 0.0f;
  }
  __syncthreads();

  const int warp = tid / 32;  // DFT: frames warp*4 .. warp*4+3
  const int lane = tid % 32;  // DFT: frequencies lane*4 .. lane*4+3 of the chunk
  const float* fr = span + warp * 4 * hop;
  const int kf4 = kf / 4;  // a weight row in units of 4 bf16

  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < kf; k0 += kChunk) {
    float re[4][4], im[4][4];  // [frame][frequency]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) re[j][i] = im[j][i] = 0.0f;
    }
    const uint2* wc = reinterpret_cast<const uint2*>(w_cos + k0) + lane;
    const uint2* ws = reinterpret_cast<const uint2*>(w_sin + k0) + lane;
#pragma unroll 4
    for (int c = 0; c < ksup; ++c) {
      float cw[4], sw[4];
      bf16x4(wc[static_cast<long long>(c) * kf4], cw);
      bf16x4(ws[static_cast<long long>(c) * kf4], sw);
      const float v[4] = {fr[c], fr[hop + c], fr[2 * hop + c], fr[3 * hop + c]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          re[j][i] = fmaf(v[j], cw[i], re[j][i]);
          im[j][i] = fmaf(v[j], sw[i], im[j][i]);
        }
      }
    }

    __syncthreads();  // the previous chunk's mel product has read mag
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m[j] = mag_in<__nv_bfloat16>(sqrtf(re[j][i] * re[j][i] + im[j][i] * im[j][i]));
      }
      *reinterpret_cast<float4*>(mag + (lane * 4 + i) * kRow + warp * 4) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();
    mel_chunk(mel, k0, mag, tid, acc);
  }
  store_log(out, acc, b, t0, n_frames, n_mels, eps, tid);
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const T*, float*, int, int, int, int,
                          int, int, int, float);

template <typename T>
int launch(KernelFn<T> kernel, size_t smem, const void* wave, const void* w_cos,
           const void* w_sin, const void* mel, void* out, int batch, int S, int n_frames,
           int hop, int off, int ksup, int kf, int n_mels, float eps, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {  // e.g. more shared memory than a block may use
    cudaGetLastError();       // clear it, so that no later launch reports it
    return static_cast<int>(err);
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(wave), static_cast<const T*>(w_cos), static_cast<const T*>(w_sin),
      static_cast<const T*>(mel), static_cast<float*>(out), S, n_frames, hop, off, ksup, kf,
      n_mels, eps);
  return static_cast<int>(cudaGetLastError());
}

size_t tile_smem(int ksup) {
  return static_cast<size_t>(std::min(ksup, kTapChunk) + kChunk) * kRow * sizeof(float);
}

}  // namespace

extern "C" {

// Shapes: wave (batch, S); w_cos, w_sin (ksup, kf); mel (kf, 128); out
// (batch, n_frames, n_mels) float32; all contiguous on the current device.
// Returns the cudaError_t of the launch (0 on success).
int logmel_f32(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
               void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
               int kf, int n_mels, float eps, void* stream) {
  return launch<float>(logmel_kernel<float>, tile_smem(ksup), wave, w_cos, w_sin, mel, out,
                       batch, S, n_frames, hop, off, ksup, kf, n_mels, eps, stream);
}

// The same with bf16 wave, w_cos, w_sin and mel; out stays float32.
int logmel_bf16(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
                void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
                int kf, int n_mels, float eps, void* stream) {
  return launch<__nv_bfloat16>(logmel_kernel<__nv_bfloat16>, tile_smem(ksup), wave, w_cos,
                               w_sin, mel, out, batch, S, n_frames, hop, off, ksup, kf,
                               n_mels, eps, stream);
}

// The bf16 function for wide supports, from a staged waveform span. The same
// arguments; w_cos and w_sin must be 8-byte aligned.
int logmel_bf16_wide(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
                     void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
                     int kf, int n_mels, float eps, void* stream) {
  const size_t smem =
      (static_cast<size_t>(span_floats(hop, ksup)) + kChunk * kRow) * sizeof(float);
  return launch<__nv_bfloat16>(logmel_wide_kernel, smem, wave, w_cos, w_sin, mel, out, batch,
                               S, n_frames, hop, off, ksup, kf, n_mels, eps, stream);
}

const char* logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
