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
// needs 2*2*239*1024 (the DFT over the window's nonzero taps, for the 1,024
// frequencies that feed a mel bin) + 2*1024*128 (mel) ~ 1.24 MFLOP against
// ~1 KB of waveform read and 512 B of output written: ~820 FLOP per byte,
// far above the card's balance point (~20 FLOP/byte for float32 outside
// the tensor cores, ~295 for bf16 in them). The kernels run the 256 taps of
// the aligned support (1.31 MFLOP). A 2047-tap support needs 8.65 MFLOP.
//
// logmel_f32_kernel (logmel_f32, the float32 parity path; it replaces
// _partial_mel, logmel_pallas.py:284, and the caller's sum over frequency
// tiles and log, :458-464) runs IEEE float32 FMA on the CUDA cores: the TPU
// kernel runs at Precision.HIGHEST for librosa parity, so no TF32, 3xTF32
// or split-bf16 product stands in. Two things bound it:
//   * operations, at the card's 67 TFLOP/s float32 FMA rate. A block of 256
//     threads owns one sample, a tile of kF32Frames = 128 frames and a slice
//     of the frequencies, and computes both products as register-blocked
//     outer products from shared memory: a thread holds re and im of 8
//     frames x 4 frequencies (the cos and sin sums of one frequency in one
//     thread), then the mel sums of 8 frames x 8 mels, and issues 64 FMAs
//     for every four 16-byte shared-memory loads (4 FMAs a word). No weight
//     is read from device memory in the inner loops;
//   * L2, for the weights. Every block reads its slice of the weight set
//     once (w_cos, w_sin: ksup x 64 a frequency chunk; mel: 64 x 128), by
//     cp.async through a ring of kF32Stages stages of 16 KB, so each weight
//     byte pulled through L2 serves 128 frames (the kernel it replaced: 32;
//     0.67 GB a launch at flagship B = 128 where it pulled 3.0 GB).
// Each warp-wide 16-byte load returns 512 bytes to registers, broadcast or
// not, so the loops are bound by the shared-memory load path about as much
// as by the FMA pipes (0.48 of the operations bound at flagship B = 128 on
// an H100; PERF.md has the measurements and tools/fma_probe.py the loop
// alone). A larger register tile would load less per FMA, but the 64 DFT
// and 64 mel sums a thread keeps already take 249 registers.
// The block stages once the waveform span its frames cover, (frames-1)*hop
// + ksup floats, and builds from it a tap-major A tile of 32 taps x 128
// frames per DFT stage (frame f, tap c is span[f*hop + c]), double-buffered
// so that one __syncthreads a stage orders everything. After the last tap
// stage of a chunk of 64 frequencies the magnitudes go from registers to a
// shared-memory tile, and two mel stages add them into the 8 x 8 mel sums
// a thread keeps in registers across the chunks: no (nk, rows, m) partial
// stack reaches device memory. Where frame tiles x batch would leave SMs
// idle (16 tiles at B = 8), the grid takes a third dimension of frequency
// slices (ops/logmel.py:f32_plan fills one wave of the SMs); each slice
// writes its partial mel sums to a scratch stack the wrapper allocates, and
// logmel_f32_reduce_kernel adds the slices in a fixed order and takes the
// log: deterministic, no atomics. Where a wide hop's span of 128 frames
// does not fit shared memory, the block takes fewer frames (f32_frames,
// which halves them as tc_frames does); its other rows compute zeros and
// are not stored.
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

constexpr int kMels = 128;  // mel columns of the (kf, kMels) mel matrix

// |re + i im| with each product and the sum rounded on its own (no FMA
// contraction), as the plain version computes it.
__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
}

// ---- logmel_f32_kernel: the float32 function on the CUDA cores ---------------

constexpr int kF32Frames = 128;  // rows of a block's products: frames of a tile
constexpr int kF32Freqs = 64;    // frequencies of a chunk; kf must be a multiple
constexpr int kF32Taps = 32;     // taps of a DFT stage
constexpr int kF32Stages = 3;    // ring depth
constexpr int kF32Threads = 256;
constexpr int kF32Row = kF32Frames + 4;  // row stride (floats) of the A and magnitude tiles
// A ring stage: cos | sin of kF32Taps taps x kF32Freqs frequencies, or 32
// mel rows x kMels: 16 KB either way.
constexpr int kF32StageFloats = 2 * kF32Taps * kF32Freqs;
static_assert(kF32StageFloats == 32 * kMels, "a mel stage fills a ring stage");
static_assert(kF32Freqs == 2 * 32, "two mel stages a frequency chunk");

// Bytes of a block's shared memory: the ring, two A tiles, the magnitude
// tile and the span of `frames` frames (rounded up to 16 bytes).
size_t f32_smem(int hop, int ksup, int frames) {
  const size_t span = (static_cast<size_t>(frames - 1) * hop + ksup + 3) / 4 * 4;
  return sizeof(float) * (static_cast<size_t>(kF32Stages) * kF32StageFloats +
                          (2 * kF32Taps + kF32Freqs) * kF32Row + span);
}

// Issues the cp.async copies of the block's stage s into `slot`. A chunk of
// frequencies is n_tc DFT stages (taps 32r.., frequencies k0..k0+63 of cos
// and sin) and two mel stages (mel rows k0 + 32h.., all kMels columns); each
// thread copies four 16-byte pieces. Taps past the support are zero-filled.
__device__ __forceinline__ void f32_issue(float* slot, int s, int n_tc, int k_first,
                                          const float* __restrict__ w_cos,
                                          const float* __restrict__ w_sin,
                                          const float* __restrict__ mel, int ksup, int kf,
                                          int tid) {
  const int per_chunk = n_tc + 2;
  const int q = s / per_chunk;
  const int r = s - q * per_chunk;
  const int k0 = k_first + q * kF32Freqs;
  if (r < n_tc) {
#pragma unroll
    for (int i = tid; i < 2 * kF32Taps * (kF32Freqs / 4); i += kF32Threads) {
      const int half = i / (kF32Taps * (kF32Freqs / 4));  // 0: cos, 1: sin
      const int row = (i / (kF32Freqs / 4)) % kF32Taps;
      const int col = (i % (kF32Freqs / 4)) * 4;
      const int tap = r * kF32Taps + row;
      const float* src = (half ? w_sin : w_cos) +
                         static_cast<long long>(min(tap, ksup - 1)) * kf + k0 + col;
      hopper::cp_async16(slot + half * kF32Taps * kF32Freqs + row * kF32Freqs + col, src,
                         tap < ksup);
    }
  } else {
    const int k_row = k0 + (r - n_tc) * 32;
#pragma unroll
    for (int i = tid; i < 32 * (kMels / 4); i += kF32Threads) {
      const int row = i / (kMels / 4);
      const int col = (i % (kMels / 4)) * 4;
      hopper::cp_async16(slot + row * kMels + col,
                         mel + static_cast<long long>(k_row + row) * kMels + col, true);
    }
  }
}

// Taps c0 .. c0+31 of the block's frames into the tap-major tile a[32][kF32Row]
// (zeros past the support and past the block's frames). The thread writes
// one tap of 16 frames 8 apart; a warp writes 8 taps x 4 frames, so its
// stores fall in 32 different banks.
__device__ __forceinline__ void f32_build_a(float* a, const float* span, int c0, int frames,
                                            int hop, int ksup, int tid) {
  const int c = (tid / 32 % 4) * 8 + tid % 8;
  const int f0 = tid / 128 * 4 + tid % 32 / 8;
  const bool tap_in = c0 + c < ksup;
  const float* src = span + f0 * hop + c0 + c;
  float* dst = a + c * kF32Row + f0;
#pragma unroll
  for (int k = 0; k < kF32Frames / 8; ++k) {
    dst[8 * k] = (tap_in && f0 + 8 * k < frames) ? src[8 * k * hop] : 0.0f;
  }
}

// The thread's rows are frames 4fg..4fg+3 and 64+4fg..64+4fg+3 (fg < 16);
// its columns are frequencies 4g..4g+3 of the chunk in the DFT and mels
// 4g..4g+3, 64+4g..64+4g+3 in the mel product (g < 16). A warp covers 4
// values of fg and 8 of g, so each 16-byte load is one shared-memory
// wavefront, broadcast to 8 (A, magnitudes) or 4 (weights) threads.
__device__ __forceinline__ void f32_dft_stage(const float* a, const float* w, int fg, int g,
                                              float (&re)[8][4], float (&im)[8][4]) {
  const float* ap = a + 4 * fg;
  const float* cp = w + 4 * g;
  const float* sp = cp + kF32Taps * kF32Freqs;
#pragma unroll
  for (int c = 0; c < kF32Taps; ++c) {
    const float4 a0 = *reinterpret_cast<const float4*>(ap + c * kF32Row);
    const float4 a1 = *reinterpret_cast<const float4*>(ap + c * kF32Row + 64);
    const float4 wc = *reinterpret_cast<const float4*>(cp + c * kF32Freqs);
    const float4 ws = *reinterpret_cast<const float4*>(sp + c * kF32Freqs);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float cv[4] = {wc.x, wc.y, wc.z, wc.w};
    const float sv[4] = {ws.x, ws.y, ws.z, ws.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        re[i][j] = fmaf(av[i], cv[j], re[i][j]);
        im[i][j] = fmaf(av[i], sv[j], im[i][j]);
      }
    }
  }
}

// Adds 32 frequencies' magnitudes (mag rows, frequency-major) times their mel
// rows (w, 32 x kMels) into acc.
__device__ __forceinline__ void f32_mel_stage(const float* mag, const float* w, int fg, int g,
                                              float (&acc)[8][8]) {
  const float* mp = mag + 4 * fg;
  const float* wp = w + 4 * g;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float4 g0 = *reinterpret_cast<const float4*>(mp + k * kF32Row);
    const float4 g1 = *reinterpret_cast<const float4*>(mp + k * kF32Row + 64);
    const float4 w0 = *reinterpret_cast<const float4*>(wp + k * kMels);
    const float4 w1 = *reinterpret_cast<const float4*>(wp + k * kMels + 64);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
    }
  }
}

// One block: sample blockIdx.y, frames blockIdx.x * frames .. +frames-1,
// frequency slice blockIdx.z of gridDim.z (chunks split as evenly as they
// go). With one slice it writes log(sum + eps) to out (batch, n_frames,
// n_mels); with more it writes slice z's sums to out + z * batch * n_frames
// * n_mels, for logmel_f32_reduce_kernel.
__global__ void __launch_bounds__(kF32Threads, 1)
logmel_f32_kernel(const float* __restrict__ wave, const float* __restrict__ w_cos,
                  const float* __restrict__ w_sin, const float* __restrict__ mel,
                  float* __restrict__ out, int S, int n_frames, int hop, int off, int ksup,
                  int kf, int n_mels, float eps, int frames) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);         // [kF32Stages][kF32StageFloats]
  float* a_tiles = ring + kF32Stages * kF32StageFloats;  // [2][kF32Taps][kF32Row]
  float* mag = a_tiles + 2 * kF32Taps * kF32Row;         // [kF32Freqs][kF32Row]
  float* span = mag + kF32Freqs * kF32Row;               // span[i] = x[t0*hop + off + i]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * frames;
  const int splits = gridDim.z;
  const int n_chunks = kf / kF32Freqs;
  const int c_first = blockIdx.z * n_chunks / splits;
  const int n_stages_chunk = (ksup + kF32Taps - 1) / kF32Taps + 2;
  const int n_tc = n_stages_chunk - 2;
  const int n_stages = ((blockIdx.z + 1) * n_chunks / splits - c_first) * n_stages_chunk;
  const int k_first = c_first * kF32Freqs;

  {  // the span (4-byte copies, zeros outside the record) joins stage 0's group
    const float* x = wave + static_cast<long long>(b) * S;
    const long long base = static_cast<long long>(t0) * hop + off;
    const int n_span = (frames - 1) * hop + ksup;
    for (int i = tid; i < n_span; i += kF32Threads) {
      const long long idx = base + i;
      const bool in = idx >= 0 && idx < S;
      hopper::cp_async4(span + i, x + (in ? idx : 0), in);
    }
  }
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < n_stages)
      f32_issue(ring + s * kF32StageFloats, s, n_tc, k_first, w_cos, w_sin, mel, ksup, kf, tid);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<kF32Stages - 2>();
  __syncthreads();
  f32_build_a(a_tiles, span, 0, frames, hop, ksup, tid);

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int fg = (warp / 2) * 4 + lane / 8;
  const int g = (warp % 2) * 8 + lane % 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  float re[8][4], im[8][4];
  int n_dft = 0;  // DFT stages done: its parity picks the A tile

  for (int s = 0; s < n_stages; ++s) {
    // Stage s has landed (this thread's copies, then everyone's), the A tile
    // of a DFT stage is built, and every thread is done with stage s - 1, so
    // its ring slot and the other A tile are free.
    hopper::cp_async_wait<kF32Stages - 2>();
    __syncthreads();
    if (s + kF32Stages - 1 < n_stages) {
      f32_issue(ring + ((s + kF32Stages - 1) % kF32Stages) * kF32StageFloats,
                s + kF32Stages - 1, n_tc, k_first, w_cos, w_sin, mel, ksup, kf, tid);
    }
    hopper::cp_async_commit();
    const float* slot = ring + (s % kF32Stages) * kF32StageFloats;
    const int r = s % n_stages_chunk;
    if (r < n_tc) {
      if (r == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.0f;
        }
      }
      f32_dft_stage(a_tiles + (n_dft % 2) * kF32Taps * kF32Row, slot, fg, g, re, im);
      ++n_dft;
      // The next DFT stage's taps: this chunk's next 32, or the next chunk's first.
      const bool last_tap = r + 1 == n_tc;
      if (!last_tap || s + 3 < n_stages) {
        f32_build_a(a_tiles + (n_dft % 2) * kF32Taps * kF32Row, span,
                    last_tap ? 0 : (r + 1) * kF32Taps, frames, hop, ksup, tid);
      }
      if (last_tap) {  // the chunk's magnitudes, for its two mel stages
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* row = mag + (4 * g + j) * kF32Row + 4 * fg;
          *reinterpret_cast<float4*>(row) =
              make_float4(magnitude(re[0][j], im[0][j]), magnitude(re[1][j], im[1][j]),
                          magnitude(re[2][j], im[2][j]), magnitude(re[3][j], im[3][j]));
          *reinterpret_cast<float4*>(row + 64) =
              make_float4(magnitude(re[4][j], im[4][j]), magnitude(re[5][j], im[5][j]),
                          magnitude(re[6][j], im[6][j]), magnitude(re[7][j], im[7][j]));
        }
      }
    } else {
      f32_mel_stage(mag + (r - n_tc) * 32 * kF32Row, slot, fg, g, acc);
    }
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  const bool split = splits > 1;
  float* dst = out + static_cast<long long>(blockIdx.z) * gridDim.y * n_frames * n_mels;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = (i < 4 ? 0 : 64) + 4 * fg + i % 4;
    const int t = t0 + f;
    if (f >= frames || t >= n_frames) continue;
    float* row = dst + (static_cast<long long>(b) * n_frames + t) * n_mels;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m0 = 64 * h + 4 * g;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = split ? acc[i][4 * h + j] : logf(acc[i][4 * h + j] + eps);
      if (n_mels % 4 == 0 && m0 + 4 <= n_mels) {
        *reinterpret_cast<float4*>(row + m0) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (m0 + j < n_mels) row[m0 + j] = v[j];
        }
      }
    }
  }
}

// out[i] = log(part[0][i] + ... + part[splits-1][i] + eps), the slices added
// in order.
__global__ void __launch_bounds__(256)
logmel_f32_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, long long n,
                         int splits, float eps) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = part[i];
    for (int z = 1; z < splits; ++z) sum += part[z * n + i];
    out[i] = logf(sum + eps);
  }
}

// Frames per block of a kernel whose block takes smem(hop, ksup, frames)
// bytes of shared memory: `tile`, halved while that exceeds what a block may
// opt in to on the current device. A support too wide even for one frame
// gets 1, and the launch fails with the CUDA error. Where the limit cannot
// be read, minus that error.
int frames_per_block(size_t (*smem)(int, int, int), int tile, int hop, int ksup) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  int frames = tile;
  while (frames > 1 && smem(hop, ksup, frames) > static_cast<size_t>(limit)) frames /= 2;
  return frames;
}

int f32_frames(int hop, int ksup) { return frames_per_block(f32_smem, kF32Frames, hop, ksup); }

int launch_f32(const void* wave, const void* w_cos, const void* w_sin, const void* mel, void* out,
               void* part, int batch, int S, int n_frames, int hop, int off, int ksup, int kf,
               int n_mels, float eps, int splits, void* stream) {
  if (kf % kF32Freqs || splits < 1 || splits > kf / kF32Freqs ||
      (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int frames = f32_frames(hop, ksup);
  if (frames < 1) return -frames;
  const size_t smem = f32_smem(hop, ksup, frames);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) {  // a span too wide for shared memory
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_frames + frames - 1) / frames, batch, splits);
  logmel_f32_kernel<<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(wave), static_cast<const float*>(w_cos),
      static_cast<const float*>(w_sin), static_cast<const float*>(mel),
      static_cast<float*>(splits > 1 ? part : out), S, n_frames, hop, off, ksup, kf, n_mels, eps,
      frames);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * n_frames * n_mels;
  const int blocks = static_cast<int>(std::min<long long>((n + 255) / 256, 1024));
  logmel_f32_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(out), n, splits, eps);
  return static_cast<int>(cudaGetLastError());
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

// Frames per block: kTile up to hop ~636 at 2048 taps, ~310 when the hop is
// odd; fewer for a wider hop.
int tc_frames(int hop, int ksup) { return frames_per_block(tc_smem, kTile, hop, ksup); }

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
  if (frames < 1) return -frames;
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
// `splits` frequency slices (1..kf/64, kf a multiple of 64), as
// ops/logmel.py:f32_plan chooses them; with more than one slice, `part` is
// (splits, batch, n_frames, n_mels) float32 scratch. Returns the
// cudaError_t of the launches (0 on success).
int logmel_f32(const void* wave, const void* w_cos, const void* w_sin, const void* mel,
               void* out, void* part, int batch, int S, int n_frames, int hop, int off,
               int ksup, int kf, int n_mels, float eps, int splits, void* stream) {
  return launch_f32(wave, w_cos, w_sin, mel, out, part, batch, S, n_frames, hop, off, ksup, kf,
                    n_mels, eps, splits, stream);
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

// Frames per block of logmel_bf16 and logmel_bf16_wide, and of logmel_f32,
// at this hop and support on the current device; minus the cudaError_t
// where the device's shared-memory limit cannot be read.
int logmel_tc_frames_per_block(int hop, int ksup) { return tc_frames(hop, ksup); }
int logmel_f32_frames_per_block(int hop, int ksup) { return f32_frames(hop, ksup); }

const char* logmel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
