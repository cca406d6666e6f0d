// Single-token GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_decode.py:
//   flash_decode_grouped (_decode_kernel) -> flash_decode_{f32,bf16}
//
// out[b, h, g, :] = softmax_j(scale * q[b, h, g, :] . k[b, j, h, :]) v[b, j, h, :]
// over the valid positions j < min(lengths[b], S), for the G query heads
// that share kv head h. Inputs: q (B, Hkv, G, D), k and v (B, S, Hkv, D),
// lengths (B,) int32, all contiguous, in f32 or bf16; the output is
// (B, Hkv, G, D) in q's type. A row of length 0 gives zeros (the reference
// clamps the softmax denominator at 1e-30), never NaN.
//
// What bounds it on this card: HBM bytes. Each valid key costs 2 * D values
// of K and V (256 B in bf16 at D = 64) for 4 * G * D flops, about 1.5 flop/B
// at G = 3: two orders of magnitude below the H100's ridge. The design:
//   * one CTA of 256 threads per (b, kv head). On the TPU the grid walked
//     the S axis in order and carried the online-softmax state in VMEM
//     scratch; here a loop inside the CTA walks the KV tiles and keeps the
//     state (running max and denominator in shared memory, the G x D
//     accumulator in registers). The G query rows sit in shared memory, f32.
//   * the loop runs over the valid rows only, min(lengths[b], S), in tiles
//     of 16 KB of K and 16 KB of V (128 keys in bf16 at D = 64). The Pallas
//     grid walks all of S and masks; the function is the same, and the
//     bytes read are those the data needs. Any S is taken, with no padding
//     copy.
//   * every global load is 16 B per thread, neighbouring threads on
//     neighbouring addresses. The next tile's loads are issued into
//     registers before the current tile is computed, so one tile (32 KB) is
//     in flight while the CTA computes.
//   * scores: one thread per (key, group of heads), 16-byte reads of the
//     key's row out of shared memory (rows padded by 16 B: no bank
//     conflicts), the query rows broadcast, four partial sums per head;
//     softmax per query row by one warp (shuffles for max and sum); the
//     value product: each thread owns 4 columns of d for every head and a
//     strided subset of the tile's keys, G x 4 independent accumulators;
//     the key subsets are summed once, after the last tile.
//   * f32 everywhere inside; expf (not __expf); positions past the length
//     get a score of -1e30 and a probability of exactly 0.
//   * the head dim is a template bound (64 or 128): loops over d unroll; a
//     smaller D (a multiple of 8) runs in the next bound up.
// The simple design leaves bandwidth on the table: B * Hkv CTAs (96 at the
// serve path's B = 32, Hkv = 3) for 132 SMs, one CTA per SM, one tile in
// flight, and no split of S across CTAs, so the longest row sets the time.
// Split-KV, TMA and wgmma are for a later change.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kTileBytes = 16384;          // one tile of K (and one of V)
constexpr float kNegInf = -1.0e30f;

// 16 bytes of T as floats: 4 for f32, 8 for bf16; 4 values as floats.
template <typename T>
struct Conv;

template <>
struct Conv<float> {
  __device__ static void chunk(const uint4& raw, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(&raw);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
  __device__ static void four(const unsigned char* p, float* out) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Conv<__nv_bfloat16> {
  __device__ static void chunk(const uint4& raw, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void four(const unsigned char* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
};

// The shapes of one instantiation: element type T, head dim bound DMAX.
template <typename T, int DMAX>
struct Cfg {
  static constexpr int kE = 16 / sizeof(T);                 // values per chunk
  static constexpr int kKeys = kTileBytes / (DMAX * sizeof(T));  // keys per tile
  static constexpr int kRow = DMAX * sizeof(T) + 16;         // padded smem row, B
  static constexpr int kChunksPerThread = kTileBytes / 16 / kThreads;  // 4
  static constexpr int kHeadGroups = kThreads / kKeys;      // score phase
  static constexpr int kHeadsPerThread = (kMaxG + kHeadGroups - 1) / kHeadGroups;
  static constexpr int kCols = DMAX / 4;                    // value phase
  static constexpr int kKeyGroups = kThreads / kCols;
  static_assert(kKeys >= 32 && kKeys <= kThreads, "a warp's keys share heads");
  static_assert(kKeyGroups * kMaxG * DMAX * 4 <= 2 * kKeys * kRow,
                "the key-group sums fit in the tile buffers");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Issue the loads of one tile (rows t0 .. t0 + kKeys - 1 of this (b, h))
// into registers; rows at or past n are left as zeros.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(const T* __restrict__ kbase,
                                          const T* __restrict__ vbase,
                                          long long row_stride, int t0, int n,
                                          int chunks_per_row, uint4* kreg,
                                          uint4* vreg) {
  using C = Cfg<T, DMAX>;
#pragma unroll
  for (int i = 0; i < C::kChunksPerThread; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int j = c / chunks_per_row;
    const int col = (c - j * chunks_per_row) * C::kE;
    kreg[i] = make_uint4(0u, 0u, 0u, 0u);
    vreg[i] = make_uint4(0u, 0u, 0u, 0u);
    if (j < C::kKeys && t0 + j < n) {
      const long long off = (long long)(t0 + j) * row_stride + col;
      kreg[i] = __ldg(reinterpret_cast<const uint4*>(kbase + off));
      vreg[i] = __ldg(reinterpret_cast<const uint4*>(vbase + off));
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int S, int Hkv, int G, int D,
                    float scale) {
  using C = Cfg<T, DMAX>;
  constexpr int kKeys = C::kKeys;
  __shared__ __align__(16) float q_s[kMaxG * DMAX];
  __shared__ __align__(16) unsigned char kv_s[2 * kKeys * C::kRow];  // K, V
  __shared__ float p_s[kMaxG * kKeys];      // scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];
  unsigned char* k_s = kv_s;
  unsigned char* v_s = kv_s + kKeys * C::kRow;

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks_per_row = D / C::kE;
  const long long row_stride = (long long)Hkv * D;
  const int n = max(0, min(lengths[b], S));

  const T* qb = q + (long long)blockIdx.x * G * D;
  const T* kb = k + (long long)b * S * row_stride + (long long)h * D;
  const T* vb = v + (long long)b * S * row_stride + (long long)h * D;

  for (int i = tid; i < kMaxG * DMAX; i += kThreads) {
    const int g = i / DMAX, d = i - g * DMAX;
    q_s[i] = (g < G && d < D) ? Conv<T>::to_float(qb[g * D + d]) : 0.0f;
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }

  // score phase: this thread's key and heads
  const int sj = tid % kKeys;
  const int shg = tid / kKeys;
  // value phase: this thread's 4 columns and key subset
  const int col = (tid % C::kCols) * 4;
  const int vjg = tid / C::kCols;
  float acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;

  uint4 kreg[C::kChunksPerThread], vreg[C::kChunksPerThread];
  if (n > 0) load_tile<T, DMAX>(kb, vb, row_stride, 0, n, chunks_per_row, kreg, vreg);

  for (int t0 = 0; t0 < n; t0 += kKeys) {
    __syncthreads();                      // the last tile's readers are done
#pragma unroll
    for (int i = 0; i < C::kChunksPerThread; ++i) {
      const int c = tid + i * kThreads;
      const int j = c / chunks_per_row;
      if (j < kKeys) {
        const int off = j * C::kRow + (c - j * chunks_per_row) * 16;
        *reinterpret_cast<uint4*>(k_s + off) = kreg[i];
        *reinterpret_cast<uint4*>(v_s + off) = vreg[i];
      }
    }
    if (t0 + kKeys < n)                   // next tile in flight meanwhile
      load_tile<T, DMAX>(kb, vb, row_stride, t0 + kKeys, n, chunks_per_row, kreg, vreg);
    __syncthreads();

    const int valid = min(kKeys, n - t0);
    {
      float s[C::kHeadsPerThread][4];
#pragma unroll
      for (int i = 0; i < C::kHeadsPerThread; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.0f;
      if (sj < valid) {
        const unsigned char* krow = k_s + sj * C::kRow;
#pragma unroll
        for (int c = 0; c < DMAX / C::kE; ++c) {
          if (c * C::kE < D) {
            float kf[C::kE];
            Conv<T>::chunk(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
#pragma unroll
            for (int i = 0; i < C::kHeadsPerThread; ++i) {
              const int g = shg + i * C::kHeadGroups;
              if (g < G) {
#pragma unroll
                for (int e4 = 0; e4 < C::kE; e4 += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(
                      q_s + g * DMAX + c * C::kE + e4);
                  s[i][0] += qv.x * kf[e4];
                  s[i][1] += qv.y * kf[e4 + 1];
                  s[i][2] += qv.z * kf[e4 + 2];
                  s[i][3] += qv.w * kf[e4 + 3];
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < C::kHeadsPerThread; ++i) {
        const int g = shg + i * C::kHeadGroups;
        if (g < G)
          p_s[g * kKeys + sj] = sj < valid
              ? ((s[i][0] + s[i][1]) + (s[i][2] + s[i][3])) * scale
              : kNegInf;
      }
    }
    __syncthreads();

    if (warp < G) {                       // softmax of query row g = warp
      float* row = p_s + warp * kKeys;
      float mx = kNegInf;
      for (int j = lane; j < valid; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[warp];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < kKeys; j += 32) {
        const float p = j < valid ? expf(row[j] - m_new) : 0.0f;
        row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[warp] = alpha;
        l_s[warp] = alpha * l_s[warp] + sum;
        m_s[warp] = m_new;
      }
    }
    __syncthreads();

    if (col < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        const float alpha = g < G ? a_s[g] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
      }
      for (int j = vjg; j < valid; j += C::kKeyGroups) {
        float vf[4];
        Conv<T>::four(v_s + j * C::kRow + col * sizeof(T), vf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float p = p_s[g * kKeys + j];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] += p * vf[e];
          }
        }
      }
    }
  }
  __syncthreads();                        // the tile buffers are free again

  // sum the key groups' partial accumulators, then normalise
  float* red = reinterpret_cast<float*>(kv_s);      // [group][g][DMAX]
  if (col < D) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float* dst = red + (vjg * kMaxG + g) * DMAX + col;
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  T* ob = out + (long long)blockIdx.x * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float sum = 0.0f;
    for (int jg = 0; jg < C::kKeyGroups; ++jg) sum += red[(jg * kMaxG + g) * DMAX + d];
    ob[i] = Conv<T>::from_float(sum / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int B, int S, int Hkv, int G, int D, float scale,
           void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  const dim3 grid(B * Hkv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  if (D <= 64)
    flash_decode_kernel<T, 64><<<grid, kThreads, 0, st>>>(qp, kp, vp, lp, op, S, Hkv, G, D, scale);
  else
    flash_decode_kernel<T, 128><<<grid, kThreads, 0, st>>>(qp, kp, vp, lp, op, S, Hkv, G, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, Hkv, G, D); k, v: (B, S, Hkv, D); lengths: (B,) int32; out: like q.
// 1 <= G <= 8, D % 8 == 0 and D <= 128; every pointer on a 16-byte boundary.
int flash_decode_f32(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, int B, int S, int Hkv,
                     int G, int D, float scale, void* stream) {
  return launch<float>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const void* lengths, void* out, int B, int S, int Hkv,
                      int G, int D, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, Hkv, G, D, scale,
                               stream);
}

}  // extern "C"
