// Packed LARS step kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lars_kernels.py:
//   norms_flat     (_norms_kernel)    -> lars_norms_flat_{f32,bf16}
//   apply_flat     (_apply_kernel)    -> lars_apply_flat_{f32,bf16}
//   apply_flat_q8  (_apply_q8_kernel) -> lars_apply_flat_q8_{f32,bf16}
//
// All work on the packed (R, 512) superbuffer of repro_torch.core.packing,
// whose layer slices are whole 8 x 512 row blocks (4096 values).
//
// What bounds them on this card: HBM bytes, and at LeNet's (272, 512) the
// launch itself. norms_flat reads w and g once (8 B per value in f32) and
// does 4 flops per value; apply_flat reads w, g, m and writes w', m' (20 B
// per value in f32) for 6 flops. Both are three orders of magnitude below
// the H100's 295 flop/B ridge, so what matters is streaming every byte once
// at full width, from every SM, with nothing carried between CTAs:
//   * every load and store is 16 B per thread (float4 / 8 x bf16), with
//     neighbouring threads on neighbouring addresses;
//   * norms_flat gives Sum w^2 and Sum g^2 per ROW: the reference's
//     norms_flat(..., block_rows=1). 64 threads own a row (8 values each,
//     every load issued before the first add) and a CTA holds 2 whole rows,
//     so LeNet's 272 rows make 136 CTAs where the TPU's grid of 8-row
//     blocks made 34 (a third of a fill of the 132 SMs). Each row is
//     reduced by warp shuffles and one shared-memory step across its two
//     warps: no atomics, no cross-CTA step, the same bits from run to run.
//     The fold of rows into layer slices stays in torch
//     (repro_torch.kernels.ops.lars_norms_packed);
//   * apply_flat is one elementwise pass in units of 16 B of w (4 f32 or
//     8 bf16 values, with their f32 momentum), one unit per thread in
//     128-thread CTAs: 272 CTAs at LeNet's size, so every SM has work.
//     Each thread issues every load (and its row block's learning rate,
//     lr_blocks[row / 8]) before the update and its stores;
//   * apply_flat_q8 holds the momentum as int8 codes with one f32 scale per
//     row block (14 B per value in f32 instead of apply_flat's 20). Its
//     requantization needs the block's new absmax before any code can be
//     written, so it gives each row block one CUDA block:
//     256 threads x 16 values, the new momentum kept in registers, the absmax
//     reduced through warp shuffles and shared memory, and only then w', the
//     codes and the scale written. The f32 momentum never reaches HBM.
//
// Arithmetic: the file is built with -fmad=false, so apply_flat rounds after
// every multiply and add exactly as the plain PyTorch version does
// (m' = mu*m + lr*(g + wd*w); w' = w - m'), and the two agree bit for bit.
// apply_flat_q8 keeps that, and quantizes as packing.quantize_q8 does:
// scale' = absmax / 127 by IEEE division (1.0 for an all-zero block), codes
// rint(m' / scale') (round half to even, IEEE division, never a reciprocal
// multiply) clipped to +-127 before the cast. The absmax is a max over the
// bit patterns of |m'|, which orders non-negative floats and puts NaN above
// +inf: a block holding a NaN gets a NaN scale (fmaxf would drop it), and
// its NaN values get code 0, as the plain version gives them.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kLane = 512;
constexpr int kBlockRows = 8;
constexpr int kBlockElems = kLane * kBlockRows;  // 4096
constexpr int kRowThreads = 64;               // norms_flat: threads per row
constexpr int kRowsPerCta = 2;                // norms_flat: rows per CTA
constexpr int kNormsThreads = kRowThreads * kRowsPerCta;
constexpr int kApplyThreads = 128;            // apply_flat: threads per CTA
constexpr int kQ8Threads = 256;
constexpr int kQ8PerThread = kBlockElems / kQ8Threads;  // 16: one 16 B code load
constexpr float kQ8Levels = 127.0f;

// The 16 bytes at p as floats: one float4 for f32, eight values for bf16.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float out[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float out[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float v[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// N consecutive values through 16-byte accesses (N a multiple of Vec16's).
template <typename T, int N>
struct VecN {
  static constexpr int kStep = Vec16<T>::kN;
  __device__ static void load(const T* p, float out[N]) {
#pragma unroll
    for (int i = 0; i < N; i += kStep) Vec16<T>::load(p + i, out + i);
  }
  __device__ static void store(T* p, const float v[N]) {
#pragma unroll
    for (int i = 0; i < N; i += kStep) Vec16<T>::store(p + i, v + i);
  }
};

template <typename T>
using Vec8 = VecN<T, 8>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// kRowsPerCta whole rows per CTA, 64 threads (two warps) per row, 8 values
// per thread: all four (f32) or two (bf16) 16 B loads before the first add.
// The row's 16 B units are dealt round the 64 threads, so each warp-wide load
// reads 512 contiguous bytes.
template <typename T>
__global__ void __launch_bounds__(kNormsThreads)
norms_flat_kernel(const T* __restrict__ w, const T* __restrict__ g,
                  float* __restrict__ wsq, float* __restrict__ gsq) {
  constexpr int N = Vec16<T>::kN;
  constexpr int kStride = kRowThreads * N;      // values between a thread's units
  const int local_row = threadIdx.x / kRowThreads;
  const size_t row = static_cast<size_t>(blockIdx.x) * kRowsPerCta + local_row;
  const size_t off = row * kLane + (threadIdx.x % kRowThreads) * N;
  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8 / N; ++j) Vec16<T>::load(w + off + j * kStride, a + j * N);
#pragma unroll
  for (int j = 0; j < 8 / N; ++j) Vec16<T>::load(g + off + j * kStride, b + j * N);
  float sw = 0.f, sg = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sw += a[i] * a[i];
    sg += b[i] * b[i];
  }
  sw = warp_sum(sw);
  sg = warp_sum(sg);
  __shared__ float part_w[kNormsThreads / 32];
  __shared__ float part_g[kNormsThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part_w[warp] = sw;
    part_g[warp] = sg;
  }
  __syncthreads();
  if (threadIdx.x % kRowThreads == 0) {
    wsq[row] = part_w[2 * local_row] + part_w[2 * local_row + 1];
    gsq[row] = part_g[2 * local_row] + part_g[2 * local_row + 1];
  }
}

// Thread t of CTA c takes unit c * kApplyThreads + t, 16 B of w: every
// load first, then the update and the stores.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
apply_flat_kernel(const float* __restrict__ lr_blocks, const T* __restrict__ w,
                  const T* __restrict__ g, const float* __restrict__ m,
                  T* __restrict__ w_out, float* __restrict__ m_out,
                  float momentum, float weight_decay, long long n_units) {
  constexpr int N = Vec16<T>::kN;
  constexpr int kUnitsPerBlock = kBlockElems / N;
  const long long u =
      static_cast<long long>(blockIdx.x) * kApplyThreads + threadIdx.x;
  if (u >= n_units) return;
  const size_t off = static_cast<size_t>(u) * N;
  float wv[N], gv[N], mv[N];
  Vec16<T>::load(w + off, wv);
  Vec16<T>::load(g + off, gv);
  VecN<float, N>::load(m + off, mv);
  const float lr = lr_blocks[u / kUnitsPerBlock];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float decayed = gv[i] + weight_decay * wv[i];
    const float m_new = momentum * mv[i] + lr * decayed;
    mv[i] = m_new;
    wv[i] = wv[i] - m_new;
  }
  Vec16<T>::store(w_out + off, wv);
  VecN<float, N>::store(m_out + off, mv);
}

// One CUDA block per 8 x 512 row block; thread t owns values [16t, 16t + 16).
template <typename T>
__global__ void __launch_bounds__(kQ8Threads)
apply_flat_q8_kernel(const float* __restrict__ lr_blocks,
                     const float* __restrict__ scale, const T* __restrict__ w,
                     const T* __restrict__ g, const int8_t* __restrict__ q,
                     T* __restrict__ w_out, int8_t* __restrict__ q_out,
                     float* __restrict__ scale_out, float momentum,
                     float weight_decay) {
  const size_t off = static_cast<size_t>(blockIdx.x) * kBlockElems +
                     static_cast<size_t>(threadIdx.x) * kQ8PerThread;
  const float lr = lr_blocks[blockIdx.x];
  const float s = scale[blockIdx.x];
  float wv[kQ8PerThread], gv[kQ8PerThread], mv[kQ8PerThread];
  Vec8<T>::load(w + off, wv);
  Vec8<T>::load(w + off + 8, wv + 8);
  Vec8<T>::load(g + off, gv);
  Vec8<T>::load(g + off + 8, gv + 8);
  const uint4 q_raw = *reinterpret_cast<const uint4*>(q + off);
  const int8_t* codes = reinterpret_cast<const int8_t*>(&q_raw);
  unsigned amax_bits = 0u;
#pragma unroll
  for (int i = 0; i < kQ8PerThread; ++i) {
    const float m = static_cast<float>(codes[i]) * s;
    const float decayed = gv[i] + weight_decay * wv[i];
    const float m_new = momentum * m + lr * decayed;
    mv[i] = m_new;
    wv[i] = wv[i] - m_new;
    amax_bits = max(amax_bits, __float_as_uint(m_new) & 0x7fffffffu);
  }
  amax_bits = __reduce_max_sync(0xffffffffu, amax_bits);
  __shared__ unsigned part[kQ8Threads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax_bits;
  __syncthreads();
  amax_bits = part[0];
#pragma unroll
  for (int k = 1; k < kQ8Threads / 32; ++k) amax_bits = max(amax_bits, part[k]);
  const float amax = __uint_as_float(amax_bits);
  const float s_new = (amax > 0.f || isnan(amax)) ? __fdiv_rn(amax, kQ8Levels) : 1.f;

  Vec8<T>::store(w_out + off, wv);
  Vec8<T>::store(w_out + off + 8, wv + 8);
  uint4 out_raw;
  int8_t* out = reinterpret_cast<int8_t*>(&out_raw);
#pragma unroll
  for (int i = 0; i < kQ8PerThread; ++i) {
    const float r = rintf(__fdiv_rn(mv[i], s_new));
    out[i] = isnan(r) ? int8_t{0}
                      : static_cast<int8_t>(static_cast<int>(
                            fminf(fmaxf(r, -kQ8Levels), kQ8Levels)));
  }
  *reinterpret_cast<uint4*>(q_out + off) = out_raw;
  if (threadIdx.x == 0) scale_out[blockIdx.x] = s_new;
}

template <typename T>
int launch_norms(const void* w, const void* g, void* wsq, void* gsq,
                 long long rows, void* stream) {
  if (rows % kRowsPerCta) return static_cast<int>(cudaErrorInvalidValue);
  const long long ctas = rows / kRowsPerCta;
  if (ctas > 0) {
    norms_flat_kernel<T><<<static_cast<unsigned>(ctas), kNormsThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(w), static_cast<const T*>(g),
        static_cast<float*>(wsq), static_cast<float*>(gsq));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* lr_blocks, const void* w, const void* g,
                 const void* m, void* w_out, void* m_out, float momentum,
                 float weight_decay, long long rows, void* stream) {
  const long long n_units = rows * kLane / Vec16<T>::kN;
  const long long ctas = (n_units + kApplyThreads - 1) / kApplyThreads;
  if (ctas > 0) {
    apply_flat_kernel<T><<<static_cast<unsigned>(ctas), kApplyThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lr_blocks), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<const float*>(m),
        static_cast<T*>(w_out), static_cast<float*>(m_out), momentum,
        weight_decay, n_units);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply_q8(const void* lr_blocks, const void* scale, const void* w,
                    const void* g, const void* q, void* w_out, void* q_out,
                    void* scale_out, float momentum, float weight_decay,
                    long long rows, void* stream) {
  const long long blocks = rows / kBlockRows;
  if (blocks > 0) {
    apply_flat_q8_kernel<T><<<static_cast<unsigned>(blocks), kQ8Threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lr_blocks), static_cast<const float*>(scale),
        static_cast<const T*>(w), static_cast<const T*>(g),
        static_cast<const int8_t*>(q), static_cast<T*>(w_out),
        static_cast<int8_t*>(q_out), static_cast<float*>(scale_out), momentum,
        weight_decay);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w, g: (rows, 512) contiguous; wsq, gsq: (rows,) f32, one sum per row.
// rows % 2 == 0.
int lars_norms_flat_f32(const void* w, const void* g, void* wsq, void* gsq,
                        long long rows, void* stream) {
  return launch_norms<float>(w, g, wsq, gsq, rows, stream);
}

int lars_norms_flat_bf16(const void* w, const void* g, void* wsq, void* gsq,
                         long long rows, void* stream) {
  return launch_norms<__nv_bfloat16>(w, g, wsq, gsq, rows, stream);
}

// lr_blocks: (rows / 8,) f32; w, g, w_out: (rows, 512) in w's dtype;
// m, m_out: (rows, 512) f32. rows % 8 == 0.
int lars_apply_flat_f32(const void* lr_blocks, const void* w, const void* g,
                        const void* m, void* w_out, void* m_out, float momentum,
                        float weight_decay, long long rows, void* stream) {
  return launch_apply<float>(lr_blocks, w, g, m, w_out, m_out, momentum,
                             weight_decay, rows, stream);
}

int lars_apply_flat_bf16(const void* lr_blocks, const void* w, const void* g,
                         const void* m, void* w_out, void* m_out, float momentum,
                         float weight_decay, long long rows, void* stream) {
  return launch_apply<__nv_bfloat16>(lr_blocks, w, g, m, w_out, m_out,
                                     momentum, weight_decay, rows, stream);
}

// lr_blocks, scale, scale_out: (rows / 8,) f32; w, g, w_out: (rows, 512) in
// w's dtype; q, q_out: (rows, 512) int8. rows % 8 == 0.
int lars_apply_flat_q8_f32(const void* lr_blocks, const void* scale,
                           const void* w, const void* g, const void* q,
                           void* w_out, void* q_out, void* scale_out,
                           float momentum, float weight_decay, long long rows,
                           void* stream) {
  return launch_apply_q8<float>(lr_blocks, scale, w, g, q, w_out, q_out,
                                scale_out, momentum, weight_decay, rows, stream);
}

int lars_apply_flat_q8_bf16(const void* lr_blocks, const void* scale,
                            const void* w, const void* g, const void* q,
                            void* w_out, void* q_out, void* scale_out,
                            float momentum, float weight_decay, long long rows,
                            void* stream) {
  return launch_apply_q8<__nv_bfloat16>(lr_blocks, scale, w, g, q, w_out,
                                        q_out, scale_out, momentum,
                                        weight_decay, rows, stream);
}

}  // extern "C"
