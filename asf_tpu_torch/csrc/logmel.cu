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
//
// logmel_kernel<float> (logmel_f32, the float32 parity path) runs IEEE
// float32 FMA on the CUDA cores: one block owns one sample and 32 frames,
// keeps a tap-major frame tile (at most kTapChunk taps, restaged per tap
// chunk for a wider support) in shared memory, loops over chunks of 128
// frequencies with the mel sums in registers (no (nk, rows, m) partial stack
// as on the TPU) and writes the log.
//
// logmel_tc_kernel (logmel_bf16 and logmel_bf16_wide: one kernel, since K3's
// hop-blocked layout is a TPU artefact) runs both products on the tensor
// cores, as wgmma with bf16 operands and float32 accumulation. The shape is
// attention's S = QK^T -> P -> O += PV with |.| in place of the softmax:
//   * one block owns one sample and kTile = 128 frames (fewer for a wide hop,
//     below): two consumer warpgroups of 64 frames each and one producer
//     warp. Every block reads the whole weight set through L2 (1.5 MB at 256
//     taps, 9.7 MB at 2048), so the tile is as tall as two warpgroups make it;
//   * the block stages once, in bf16, the contiguous waveform span its frames
//     cover, (frames-1)*hop + support samples (34 KB at hop 120 and 2048 taps,
//     where frames overlap ~17x), and for an odd hop a second copy one sample
//     on, so that every frame row's sample pairs are aligned 32-bit words.
//     Frame f, tap c is span[f*hop + c]: no shared-memory descriptor
//     expresses that row stride, so the DFT's A operand comes from registers;
//   * B streams through a ring of kStages shared-memory stages of 8 KB,
//     loaded by TMA straight from the row-major weights: a DFT stage is 64
//     taps x 32 frequencies of w_cos and of w_sin (64-byte swizzle), a mel
//     stage 32 frequencies x 128 mels (128-byte swizzle). The cos and sin
//     wgmmas (N = 32) give one thread re and im of the same (frame,
//     frequency);
//   * after a chunk of 32 frequencies, |.| rounded to bf16 RN is repacked in
//     registers as the A operand of the mel product (FlashAttention-3's P).
//     The (128 x 128) mel sums stay in registers across the kf/32 chunks and
//     log(acc + eps) is the epilogue.
// Summation: every wgmma starts from a zero accumulator, and the running
// sums are IEEE float32 adds of its results in order (the comment in the
// kernel gives the reason); the float32 adds, not the tensor cores, are most
// of the consumers' instructions. Registers: 64 mel sums + 32 re/im + 32 of
// the two wgmmas in flight a thread, 162 in all, no spills.
// Shared memory: the 64 KB ring and the span. Where a wide hop's span of
// kTile frames does not fit the 227 KB a block may hold (hops above ~636
// samples at 2048 taps, ~310 when odd), the block takes 64, 32, ... frames:
// its wgmmas keep kTile rows, and the rows past its frames repeat them and
// are not stored. Any hop runs; the main paths' geometries take kTile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kFrames = 32;     // frames per block
constexpr int kChunk = 128;     // frequencies per chunk; kf must be a multiple
constexpr int kMels = 128;      // mel columns of the (kf, kMels) mel matrix
constexpr int kThreads = 256;
constexpr int kRow = kFrames + 4;  // shared-memory row stride in floats (16-byte aligned rows)
constexpr int kTapChunk = 256;     // taps of the frame tile of logmel_kernel

__device__ __forceinline__ float to_float(float v) { return v; }

// The magnitude enters the mel product in the weights' type.
template <typename T>
__device__ __forceinline__ float mag_in(float v);
template <>
__device__ __forceinline__ float mag_in<float>(float v) { return v; }

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


// ---- logmel_tc_kernel: the bf16 function on the tensor cores ----------------

constexpr int kTile = 128;          // wgmma rows of a block: two consumer warpgroups of 64
constexpr int kTcTaps = 64;         // taps of a DFT stage
constexpr int kTcFreqs = 32;        // frequencies of a chunk: cos and sin wgmmas of N = 32
constexpr int kBoxBytes = 4096;     // a TMA box: 64 taps x 32 frequencies, or 32 x 64 mels
constexpr int kStageBytes = 2 * kBoxBytes;
constexpr int kStages = 8;          // ring depth
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kTcThreads = kConsumers + 32;  // and the producer warp

// bf16 of one staged copy of the span under a block's `frames` frames:
// (frames-1)*hop + the support rounded up to a stage, + 2 for the last pair's
// second word.
__host__ __device__ __forceinline__ int span_elems(int hop, int ksup, int frames) {
  const int taps = (ksup + kTcTaps - 1) / kTcTaps * kTcTaps;
  return ((frames - 1) * hop + taps + 2 + 7) / 8 * 8;
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// |re + i im| with each product and the sum rounded on its own (no FMA
// contraction), as the plain version computes it.
__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

__global__ void __launch_bounds__(kTcThreads, 1)
logmel_tc_kernel(const __grid_constant__ CUtensorMap cos_map,
                 const __grid_constant__ CUtensorMap sin_map,
                 const __grid_constant__ CUtensorMap mel_map,
                 const __nv_bfloat16* __restrict__ wave, float* __restrict__ out, int S,
                 int n_frames, int hop, int off, int ksup, int kf, int n_mels, float eps,
                 int frames) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzled boxes must start on 1024 bytes.
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  // span[i] = x[t0*hop + off + i]; for an odd hop also span[n_span + i] =
  // x[... + i + 1], so that every frame row's sample pairs are aligned words.
  uint16_t* span = reinterpret_cast<uint16_t*>(empty + kStages);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * frames;
  const int n_tap_stages = (ksup + kTcTaps - 1) / kTcTaps;
  const int n_chunks = kf / kTcFreqs;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one thread walks the consumers' order of stages, each chunk's
    // DFT stages then its mel stage, and loads each into a free ring slot.
    if (tid == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int chunk = 0; chunk < n_chunks; ++chunk) {
        const int k0 = chunk * kTcFreqs;
        for (int ts = 0; ts <= n_tap_stages; ++ts) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], kStageBytes);
          uint8_t* dst = ring + stage * kStageBytes;
          if (ts < n_tap_stages) {  // taps ts*64.., cos | sin of frequencies k0..k0+31
            hopper::tma_load_2d(dst, &cos_map, k0, ts * kTcTaps, &full[stage]);
            hopper::tma_load_2d(dst + kBoxBytes, &sin_map, k0, ts * kTcTaps, &full[stage]);
          } else {  // mel rows k0..k0+31, mels 0..63 | 64..127
            hopper::tma_load_2d(dst, &mel_map, 0, k0, &full[stage]);
            hopper::tma_load_2d(dst + kBoxBytes, &mel_map, 64, k0, &full[stage]);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers. Stage the span in bf16 (2-byte reads: a row of the waveform
  // starts at an odd byte offset when S is odd).
  const int n_span = span_elems(hop, ksup, frames);
  {
    const uint16_t* x = reinterpret_cast<const uint16_t*>(wave) + static_cast<long long>(b) * S;
    const long long base = static_cast<long long>(t0) * hop + off;
    for (int i = tid; i < ((hop & 1) ? 2 : 1) * n_span; i += kConsumers) {
      const long long idx = base + (i < n_span ? i : i - n_span + 1);
      span[i] = (idx >= 0 && idx < S) ? x[idx] : static_cast<uint16_t>(0);
    }
    hopper::named_barrier_sync(1, kConsumers);
  }

  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  // The thread holds rows f and f+8 of the block's kTile wgmma rows. Row r is
  // frame t0 + r for r < frames; where a wide hop left fewer frames than rows
  // (frames a power of two), row r repeats frame r % frames and is not
  // stored. It reads taps 2q, 2q+1 (+8) of each k-step, from the shifted copy
  // where the frame's first tap is odd.
  const int f = wg * 64 + warp * 16 + lane / 4;
  auto row_addr = [&](int r) {
    const int o = (r & (frames - 1)) * hop + 2 * (lane % 4);
    return hopper::smem_addr(span) + 2 * ((o & 1) ? n_span + o - 1 : o);
  };
  const uint32_t row0 = row_addr(f);
  const uint32_t row1 = row_addr(f + 8);

  // Each wgmma (16 taps, or 16 frequencies) starts afresh, and the tensor
  // cores return the exact sum of its 16 products rounded toward zero to
  // float32; the running sums (re, im, acc) add these partial sums in order
  // with IEEE float32 adds. ops/logmel.py:tc_matmul repeats these rounding
  // points, and chip_smoke.py holds the eval probabilities to a front end
  // that sums so (logmel_bf16_tc_model); a chained accumulator rounds at
  // points no plain code is known to repeat. Against float32 sums the two
  // forms are as far apart: on an H100 at the flagship geometry, B = 128,
  // mean abs 9.9e-8 (this form) and 1.1e-7 (chained) from the float32 plain
  // version, 13x the CUDA cores' float32 FMA. Two wgmmas run while the thread adds the
  // partial sum of a third: cos and sin of a k-step, then sin of one and cos
  // of the next, and the two halves of the mel columns.
  float acc[64];  // mel sums: acc[32n + 4i + 2h + e] is row f + 8h, mel 64n + 8i + 2q + e
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  // Descriptor of a DFT stage's k-step 0 cos columns (box 1 is sin; a k-step
  // is 16 rows of 64 bytes on), or of a mel stage's rows 0..15 of mels 0..63
  // (box 1 is mels 64..127; 16 rows of 128 bytes on). Offsets are added in
  // the descriptor's 16-byte units.
  auto dft_desc = [&](int s) {
    return hopper::desc_mn(ring + s * kStageBytes, hopper::Swizzle::k64B, kBoxBytes, 512);
  };
  constexpr uint64_t kBox = kBoxBytes / 16, kDftStep = 1024 / 16, kMelStep = 2048 / 16;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // re[4i + 2h + e], im[...]: row f + 8h, frequency 32 chunk + 8i + 2q + e.
    float re[16], im[16], pc[16], ps[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) re[i] = im[i] = 0.0f;
    uint32_t a[2][4];  // the A of even and odd k-steps
    auto load_a = [&](uint32_t (&x)[4], uint32_t tap_bytes) {
      x[0] = hopper::lds_b32(row0 + tap_bytes);
      x[1] = hopper::lds_b32(row1 + tap_bytes);
      x[2] = hopper::lds_b32(row0 + tap_bytes + 16);
      x[3] = hopper::lds_b32(row1 + tap_bytes + 16);
    };
    load_a(a[0], 0);
    hopper::mbar_wait(&full[stage], phase);
    uint64_t desc = dft_desc(stage);
    hopper::wgmma_start(pc, a[0], desc);
    hopper::wgmma_start(ps, a[0], desc + kBox);
    // Stage ts: takes its k-steps' cos and sin partial sums and starts each
    // next k-step's (at kk = 3 the next stage's first).
    auto dft_stage = [&](int ts, auto is_last) {
      constexpr bool kLast = decltype(is_last)::value;
      const int after = stage + 1 == kStages ? 0 : stage + 1;
      const uint64_t desc_after = dft_desc(after);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bool more = !(kLast && kk == 3);
        uint32_t (&an)[4] = a[(kk + 1) & 1];
        const uint64_t dn = kk == 3 ? desc_after : desc + (kk + 1) * kDftStep;
        if (more) load_a(an, 2 * (ts * kTcTaps + 16 * (kk + 1)));
        hopper::wgmma_take<1>(pc);
#pragma unroll
        for (int i = 0; i < 16; ++i) re[i] += pc[i];
        if (more) {
          if (kk == 3) hopper::mbar_wait(&full[after], after == 0 ? phase ^ 1 : phase);
          hopper::wgmma_start(pc, an, dn);
          hopper::wgmma_take<1>(ps);
        } else {
          hopper::wgmma_take<0>(ps);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) im[i] += ps[i];
        if (kk == 3) hopper::mbar_arrive(&empty[stage]);
        if (more) hopper::wgmma_start(ps, an, dn + kBox);
      }
      desc = desc_after;
      stage = after;
      if (after == 0) phase ^= 1;
    };
    for (int ts = 0; ts + 1 < n_tap_stages; ++ts) dft_stage(ts, std::false_type{});
    dft_stage(n_tap_stages - 1, std::true_type{});

    // |DFT| in bf16 as the mel product's A: k-step j covers the chunk's
    // frequencies 16j..16j+15, i.e. elements 8j..8j+7.
    uint32_t p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * j + 2 * r;
        p[j][r] = bf16_pair(magnitude(re[x], im[x]), magnitude(re[x + 1], im[x + 1]));
      }
    }
    hopper::mbar_wait(&full[stage], phase);
    const uint64_t dm = hopper::desc_mn(ring + stage * kStageBytes, hopper::Swizzle::k128B,
                                        kBoxBytes, 1024);
    float m0[32], m1[32];  // mels 0..63 and 64..127
    hopper::wgmma_start(m0, p[0], dm);
    hopper::wgmma_start(m1, p[0], dm + kBox);
    hopper::wgmma_take<1>(m0);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += m0[i];
    hopper::wgmma_start(m0, p[1], dm + kMelStep);
    hopper::wgmma_take<1>(m1);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 + i] += m1[i];
    hopper::wgmma_start(m1, p[1], dm + kBox + kMelStep);
    hopper::wgmma_take<1>(m0);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += m0[i];
    hopper::wgmma_take<0>(m1);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 + i] += m1[i];
    hopper::mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = logf(acc[i] + eps);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + f + 8 * h;
    if (f + 8 * h >= frames || t >= n_frames) continue;
    float* row = out + (static_cast<long long>(b) * n_frames + t) * n_mels;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 64 * n + 8 * i + 2 * (lane % 4) + e;
          if (m < n_mels) row[m] = acc[32 * n + 4 * i + 2 * h + e];
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded,
// without linking it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A map of (box_rows, box_cols) boxes over a row-major (rows, cols) bf16
// matrix, swizzled as the box's row width needs (128 bytes: 64 columns, 64
// bytes: 32); boxes past its edge are filled with zeros.
bool box_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows, int box_cols) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t tc_smem(int hop, int ksup, int frames) {
  return 1024 + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) +
         static_cast<size_t>((hop & 1) ? 2 : 1) * span_elems(hop, ksup, frames) * 2;
}

// Frames per block: kTile, halved while the span of a wide hop does not fit
// the shared memory a block may opt in to (kTile up to hop ~636 at 2048 taps,
// ~310 when the hop is odd). A support too wide even for one frame gets 1,
// and the launch fails with the CUDA error.
int tc_frames(int hop, int ksup) {
  int device = 0, limit = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
          cudaSuccess) {
    cudaGetLastError();
    return kTile;
  }
  int frames = kTile;
  while (frames > 1 && tc_smem(hop, ksup, frames) > static_cast<size_t>(limit)) frames /= 2;
  return frames;
}

int launch_tc(const void* wave, const void* w_cos, const void* w_sin, const void* mel, void* out,
              int batch, int S, int n_frames, int hop, int off, int ksup, int kf, int n_mels,
              float eps, void* stream) {
  CUtensorMap cos_map, sin_map, mel_map;
  if (!box_map(&cos_map, w_cos, ksup, kf, kTcTaps, kTcFreqs) ||
      !box_map(&sin_map, w_sin, ksup, kf, kTcTaps, kTcFreqs) ||
      !box_map(&mel_map, mel, kf, kMels, kTcFreqs, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int frames = tc_frames(hop, ksup);
  const size_t smem = tc_smem(hop, ksup, frames);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {  // a support too wide for shared memory
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid((n_frames + frames - 1) / frames, batch);
  logmel_tc_kernel<<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cos_map, sin_map, mel_map, static_cast<const __nv_bfloat16*>(wave),
      static_cast<float*>(out), S, n_frames, hop, off, ksup, kf, n_mels, eps, frames);
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
  return launch<float>(logmel_kernel<float>, tile_smem(ksup), wave, w_cos, w_sin, mel, out,
                       batch, S, n_frames, hop, off, ksup, kf, n_mels, eps, stream);
}

// The same with bf16 wave, w_cos, w_sin and mel (weights 16-byte aligned, kf
// a multiple of 32); out stays float32. On the tensor cores.
int logmel_bf16(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
                void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
                int kf, int n_mels, float eps, void* stream) {
  return launch_tc(wave, w_cos, w_sin, mel, out, batch, S, n_frames, hop, off, ksup, kf, n_mels,
                   eps, stream);
}

// K3's symbol: the same kernel, which takes wide supports as they come.
int logmel_bf16_wide(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
                     void* out, int batch, int S, int n_frames, int hop, int off, int ksup,
                     int kf, int n_mels, float eps, void* stream) {
  return launch_tc(wave, w_cos, w_sin, mel, out, batch, S, n_frames, hop, off, ksup, kf, n_mels,
                   eps, stream);
}

// Frames per block of logmel_bf16 and logmel_bf16_wide at this hop and
// support, on the current device.
int logmel_tc_frames_per_block(int hop, int ksup) { return tc_frames(hop, ksup); }

const char* logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
