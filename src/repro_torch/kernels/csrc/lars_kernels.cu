// Packed LARS step kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/lars_kernels.py:
//   norms_flat  (_norms_kernel) -> lars_norms_flat_{f32,bf16}
//   apply_flat  (_apply_kernel) -> lars_apply_flat_{f32,bf16}
//
// Both work on the packed (R, 512) superbuffer of repro_torch.core.packing,
// whose layer slices are whole 8 x 512 row blocks (4096 values).
//
// What bounds them on this card: HBM bytes. norms_flat reads w and g once
// (8 B per value in f32) and does 4 flops per value; apply_flat reads w, g, m
// and writes w', m' (20 B per value in f32) for 6 flops. Both are three orders
// of magnitude below the H100's 295 flop/B ridge, so the only thing that
// matters is streaming every byte once at full width:
//   * every load and store is 16 B per thread (float4 / 8 x bf16), with
//     neighbouring threads on neighbouring addresses;
//   * norms_flat gives each 8 x 512 row block its own CUDA block. On the TPU
//     the grid ran the row blocks in sequence; here they run in parallel and
//     nothing is carried between them: each block writes its own partial sums
//     (warp shuffles, then shared memory), with no atomics, so the sums are
//     the same from run to run. The fold of blocks into layer slices stays in
//     torch (repro_torch.kernels.ops.lars_norms_packed).
//   * apply_flat is one elementwise pass; each thread reads its row block's
//     learning rate lr_blocks[row / 8].
// The simple design leaves work on the table at LeNet's size (272 rows give
// norms_flat 34 blocks for 132 SMs, and launch latency dominates); that is for
// a later change.
//
// Arithmetic: the file is built with -fmad=false, so apply_flat rounds after
// every multiply and add exactly as the plain PyTorch version does
// (m' = mu*m + lr*(g + wd*w); w' = w - m'), and the two agree bit for bit.
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
constexpr int kNormThreads = 256;
constexpr int kApplyThreads = 256;

// Eight values per 16-byte load: two float4 for f32, one uint4 for bf16.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float out[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ static void store(float* p, const float v[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float out[8]) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
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
    reinterpret_cast<uint4*>(p)[0] = raw;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One CUDA block per 8 x 512 row block: 256 threads x 2 chunks of 8 values.
template <typename T>
__global__ void __launch_bounds__(kNormThreads)
norms_flat_kernel(const T* __restrict__ w, const T* __restrict__ g,
                  float* __restrict__ wsq, float* __restrict__ gsq) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlockElems;
  float sw = 0.f, sg = 0.f;
#pragma unroll
  for (int c = 0; c < kBlockElems / (8 * kNormThreads); ++c) {
    const size_t off = base + (static_cast<size_t>(c) * kNormThreads + threadIdx.x) * 8;
    float a[8], b[8];
    Vec8<T>::load(w + off, a);
    Vec8<T>::load(g + off, b);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sw += a[i] * a[i];
      sg += b[i] * b[i];
    }
  }
  sw = warp_sum(sw);
  sg = warp_sum(sg);
  __shared__ float part_w[kNormThreads / 32];
  __shared__ float part_g[kNormThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_w[warp] = sw;
    part_g[warp] = sg;
  }
  __syncthreads();
  if (warp == 0) {
    sw = lane < kNormThreads / 32 ? part_w[lane] : 0.f;
    sg = lane < kNormThreads / 32 ? part_g[lane] : 0.f;
    sw = warp_sum(sw);
    sg = warp_sum(sg);
    if (lane == 0) {
      wsq[blockIdx.x] = sw;
      gsq[blockIdx.x] = sg;
    }
  }
}

// Each thread updates 8 consecutive values of one row block.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
apply_flat_kernel(const float* __restrict__ lr_blocks, const T* __restrict__ w,
                  const T* __restrict__ g, const float* __restrict__ m,
                  T* __restrict__ w_out, float* __restrict__ m_out,
                  float momentum, float weight_decay, long long n_chunks) {
  const long long chunk = static_cast<long long>(blockIdx.x) * kApplyThreads + threadIdx.x;
  if (chunk >= n_chunks) return;
  const size_t off = static_cast<size_t>(chunk) * 8;
  const float lr = lr_blocks[off / kBlockElems];
  float wv[8], gv[8], mv[8];
  Vec8<T>::load(w + off, wv);
  Vec8<T>::load(g + off, gv);
  Vec8<float>::load(m + off, mv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float decayed = gv[i] + weight_decay * wv[i];
    const float m_new = momentum * mv[i] + lr * decayed;
    mv[i] = m_new;
    wv[i] = wv[i] - m_new;
  }
  Vec8<T>::store(w_out + off, wv);
  Vec8<float>::store(m_out + off, mv);
}

template <typename T>
int launch_norms(const void* w, const void* g, void* wsq, void* gsq,
                 long long rows, void* stream) {
  const long long blocks = rows / kBlockRows;
  if (blocks > 0) {
    norms_flat_kernel<T><<<static_cast<unsigned>(blocks), kNormThreads, 0,
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
  const long long n_chunks = rows * kLane / 8;
  const long long blocks = (n_chunks + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 0) {
    apply_flat_kernel<T><<<static_cast<unsigned>(blocks), kApplyThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lr_blocks), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<const float*>(m),
        static_cast<T*>(w_out), static_cast<float*>(m_out), momentum,
        weight_decay, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// w, g: (rows, 512) contiguous; wsq, gsq: (rows / 8,) f32. rows % 8 == 0.
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

}  // extern "C"
