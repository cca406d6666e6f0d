// Single-token GQA decode attention for Hopper (sm_90a), split over the
// keys of the cache.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_decode.py:
//   flash_decode_grouped (_decode_kernel) -> flash_decode_{f32,bf16}
//
// out[b, h, g, :] = softmax_j(scale * q[b, h, g, :] . k[b, j, h, :]) v[b, j, h, :]
// over the valid positions j < min(lengths[b], S), for the G query heads
// that share kv head h. Inputs: q (B, Hkv, G, D), k and v (B, S, Hkv, D),
// lengths (B,) int32, all contiguous, in f32 or bf16; the output is
// (B, Hkv, G, D) in q's type. A row of length 0 gives zeros, never NaN.
//
// What bounds it on this card: HBM bytes. Each valid key costs 2 * D values
// of K and V for 4 * G * D flops, 1.5-2.5 flop/B: two orders of magnitude
// below the H100's ridge. The design keeps enough bytes in flight on every
// SM and keeps the arithmetic per byte small enough to hide behind them:
//   * split-KV. The grid is (B * Hkv) x splits; split s of a (b, h) pair
//     walks keys [s * keys_per_split, (s + 1) * keys_per_split) of the
//     valid rows. The host chooses the split count from the shapes and the
//     SM count only (never from lengths, which would cost a sync): a few
//     waves of CTAs over the card whatever B * Hkv is. A split that starts
//     at or past min(lengths[b], S) exits at once, so short rows cost
//     nothing and the longest row no longer sets the time.
//   * the 4 warps of a CTA are independent streams. Warp w takes tiles w,
//     w + 4, ... of its split (a K tile and a V tile) and copies them
//     global -> shared with cp.async, 16 B per lane, into a ring of its
//     own: two or three tiles are in flight while one is computed, and
//     nothing is staged through registers. Only __syncwarp orders the ring:
//     no block-wide barrier in the loop. Rows of one (b, h) are Hkv * D
//     values apart; rows past the valid length (and chunks past D) are
//     zero-filled by the copy (src-size 0). Shared-memory rows are
//     XOR-swizzled by 16-byte chunk, so the reads are free of bank
//     conflicts without padding.
//   * each warp keeps its own online softmax in registers (running max,
//     denominator, its slice of the accumulator), with scores, maxima and
//     sums through warp shuffles.
//     - bf16: tensor cores. Per tile of 16 keys, the scores are
//       mma.sync m16n8k16 (bf16 in, f32 accumulate; the G query rows padded
//       to 16, held as A fragments in registers for the whole split; K by
//       ldmatrix): bf16 products are exact in f32. Lane (r, t) holds row
//       g = r's scores for 4 keys, so its max and sum take 2 shuffles. The
//       value product keeps P in f32: P = hi + mid + lo, three bf16 terms
//       that carry all 24 bits of the f32 P, each an m16n8k16 against V
//       (ldmatrix.trans) into an f32 accumulator; the score's C fragments
//       are the value product's A fragments, with no data movement.
//     - f32: CUDA cores (no TF32). Per tile of 8 or 4 keys, 32 / keys lanes
//       share a key's dot product over their chunks of d (query rows in
//       shared memory, scaled), summed by shuffles; each lane owns D / 32
//       columns of the accumulator for every head, and a probability
//       reaches the value product by one shuffle per key and head.
//   * the merge stays in the launch. After its last tile a CTA merges its
//     warps through shared memory (one barrier) and, if its (b, h) has more
//     than one valid split, writes (m, l, accumulator) to an f32 workspace,
//     fences, and takes a ticket (an integer per (b, h)). The CTA that takes
//     the last ticket merges the splits in split order and resets the
//     ticket to 0. No float atomics: two calls give the same bits.
//   * f32 inside; scores in base 2 (scale * log2 e, then exp2f); positions
//     past the length get a score of -1e30 and a probability of exactly 0.
//     The head dim is a template bound (64, 128 or 256); a smaller D (a
//     multiple of 8) runs in the next bound up.
//   * bf16 past D 128 (paligemma's MQA: G 8, D 256) runs a kernel of its
//     own, flash_decode_wide_kernel. At D 256 the one above would hold
//     192 KB of rings (one 4-warp CTA an SM), pad G to the MMA's 16 rows,
//     issue an accumulator's three value MMAs back to back, and merge the
//     splits one L2 round trip at a time. The wide kernel instead:
//     - puts the keys on the MMA's M rows, so no row is padding: scores
//       S^T = K Q^T (K by ldmatrix as A; Q^T by ldmatrix from the query
//       rows in shared memory as B; four independent chains over d),
//       values O^T += V^T P^T (V^T by ldmatrix.trans as A); P's f32 values
//       again as three bf16 terms, moved from the score's C layout to B
//       fragments by movmatrix.trans. 4 MMAs per key instead of 8, issued
//       in groups after their ldmatrix, so that no MMA waits on the one
//       before it; max and sum over the 8 lanes of a head; a tile whose
//       maxima did not move skips the rescale.
//     - copy warps apart from the math: 4 copy warps, each with a fixed
//       share of a 12-stage ring (16 keys of K and V a stage, rows padded
//       to 2 DMAX + 16 bytes so ldmatrix's 8 rows hit distinct banks).
//       Lane c copies 16-byte chunk c of every K and V row of a tile by
//       cp.async, zero-filling rows past the valid keys and the chunk past
//       D that the last k-step reads, and arrives on the stage's mbarrier
//       when its copies land (cp.async.mbarrier.arrive); 8 consumer warps
//       take the tiles in turn and hand each stage back on a second
//       mbarrier. No consumer register holds a copy's address, and one
//       warp's copies (~20 B a cycle) no longer cap the CTA's stream.
//       207 KB a CTA: one CTA an SM, 12 warps.
//     - the host's plan aims at one CTA an SM with splits of 128 keys or
//       more (one tile for each consumer warp). The last CTA of a pair
//       reads every split's (m, l) while the first splits' accumulators
//       are on their way to shared memory by cp.async, and sums them in
//       split order; the ticket is an acq_rel atomic, with no full fence.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of its launch (or the error of
// setting the kernel's dynamic shared memory, the first time on a device).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;
constexpr int kMaxDevices = 64;
constexpr int kNoRow = 1 << 29;            // a copy slot past D: zero-fill
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// c[0..1] += A B for rows 0-7 of a 16 x 8 tile: A (16 x 16 bf16) has rows
// 8-15 zero (a1 = a3 = 0), so rows 8-15 of the product are dropped.
__device__ __forceinline__ void mma_rows8(float* c, uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%11};\n"
      : "+f"(c[0]), "+f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.0f),
        "f"(0.0f));
  (void)d2;
  (void)d3;
}

// c += A B, a full m16n8k16 (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's 8 x 8 b16 matrix, one 32-bit fragment a lane, transposed.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Arrive on `bar` once every cp.async this thread has issued has landed
// (the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) = hi + mid + lo in three packed bf16 pairs: 24 bits of each f32.
__device__ __forceinline__ void split3(float x, float y, uint32_t* hi,
                                       uint32_t* mid, uint32_t* lo) {
  const float xh = __bfloat162float(__float2bfloat16_rn(x));
  const float yh = __bfloat162float(__float2bfloat16_rn(y));
  const float xr = x - xh, yr = y - yh;
  const float xm = __bfloat162float(__float2bfloat16_rn(xr));
  const float ym = __bfloat162float(__float2bfloat16_rn(yr));
  *hi = pack_bf16(xh, yh);
  *mid = pack_bf16(xm, ym);
  *lo = pack_bf16(xr - xm, yr - ym);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T>
struct Conv;

template <>
struct Conv<float> {
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Conv<bf16> {
  __device__ static float to_float(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from_float(float x) { return __float2bfloat16(x); }
};

// One tile's copies: this lane's SLOTS 16-byte chunks of the K tile and of
// the V tile (the V tile tile_bytes after the K tile). A slot whose row is
// at or past rows_left, or that lies past D (row kNoRow), is zero-filled.
template <typename T, int SLOTS>
__device__ __forceinline__ void copy_tile(uint32_t st, int tile_bytes,
                                          const T* kt, const T* vt,
                                          const int* soff, const int* srow,
                                          const long long* goff,
                                          int rows_left) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const bool ok = srow[s] < rows_left;
    const long long off = ok ? goff[s] : 0;   // row 0 is valid memory
    cp_async16(st + soff[s], kt + off, ok ? 16 : 0);
    cp_async16(st + tile_bytes + soff[s], vt + off, ok ? 16 : 0);
  }
  cp_async_commit();
}

// The first steps of both kernels: which keys this CTA reads, or none.
struct Split {
  int pair, b, h, n, nvalid, k0, k1;
};

template <typename T>
__device__ __forceinline__ bool open_split(const int* lengths, T* out, int S,
                                           int Hkv, int G, int D,
                                           int keys_per_split, Split* sp) {
  sp->pair = blockIdx.x;
  sp->b = sp->pair / Hkv;
  sp->h = sp->pair - sp->b * Hkv;
  sp->n = max(0, min(lengths[sp->b], S));
  sp->nvalid = (sp->n + keys_per_split - 1) / keys_per_split;
  const int split = blockIdx.y;
  if (split >= sp->nvalid) {              // nothing to read in this split
    if (sp->n == 0 && split == 0) {
      T* ob = out + (long long)sp->pair * G * D;
      for (int i = threadIdx.x; i < G * D; i += kThreads)
        ob[i] = Conv<T>::from_float(0.0f);
    }
    return false;
  }
  sp->k0 = split * keys_per_split;
  sp->k1 = min(sp->k0 + keys_per_split, sp->n);
  return true;
}

// After the loop, every warp has written its state to red[warp][g][0..DMAX+1]
// (accumulator, m, l) and the CTA has synchronised. Merge the warps; with one
// valid split store the output, else write the split's state to the
// workspace and let the last CTA of the pair merge the splits in order.
template <typename T, int DMAX>
__device__ __forceinline__ void finish(const float* red, T* out, float* ws,
                                       int* tickets, const Split& sp,
                                       int splits, int G, int D) {
  constexpr int kRed = DMAX + 2;
  __shared__ int last_ticket;
  const int tid = threadIdx.x;
  const bool single = sp.nvalid == 1;
  T* ob = out + (long long)sp.pair * G * D;
  float* wsp = ws + ((long long)sp.pair * splits + blockIdx.y) * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[(w * kMaxG + g) * kRed + DMAX]);
    float a = 0.0f, den = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* r = red + (w * kMaxG + g) * kRed;
      const float f = exp2f(r[DMAX] - mx);
      a += r[d] * f;
      den += r[DMAX + 1] * f;
    }
    if (single) {
      ob[i] = Conv<T>::from_float(a / fmaxf(den, 1e-30f));
    } else {
      float* wg = wsp + g * (D + 2);
      wg[d] = a;
      if (d == 0) {
        wg[D] = mx;
        wg[D + 1] = den;
      }
    }
  }
  if (single) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) last_ticket = atomicAdd(tickets + sp.pair, 1) == sp.nvalid - 1;
  __syncthreads();
  if (!last_ticket) return;
  __threadfence();
  const float* wp = ws + (long long)sp.pair * splits * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float mx = kNegInf;
    for (int s = 0; s < sp.nvalid; ++s)
      mx = fmaxf(mx, __ldcg(wp + (s * G + g) * (D + 2) + D));
    float a = 0.0f, den = 0.0f;
    for (int s = 0; s < sp.nvalid; ++s) {   // split order: the same bits
      const float* wg = wp + (s * G + g) * (D + 2);
      const float f = exp2f(__ldcg(wg + D) - mx);
      a += __ldcg(wg + d) * f;
      den += __ldcg(wg + D + 1) * f;
    }
    ob[i] = Conv<T>::from_float(a / fmaxf(den, 1e-30f));
  }
  if (tid == 0) tickets[sp.pair] = 0;     // ready for the next call
}

// ------------------------------------------------------- bf16: tensor cores

template <int DMAX>
struct MmaCfg {
  static constexpr int kStages = 3;
  static constexpr int kKeys = 16;                       // per warp tile
  static constexpr int kChunks = DMAX / 8;               // 16 B per row
  static constexpr int kRowBytes = DMAX * 2;
  static constexpr int kTile = kKeys * kRowBytes;        // K (or V) tile
  static constexpr int kSlots = kKeys * kChunks / 32;    // copies per lane
  static constexpr int kKS = DMAX / 16;                  // score k-steps
  static constexpr int kNB = DMAX / 8;                   // value n-blocks
  static constexpr int kWarpRing = kStages * 2 * kTile;
  static constexpr int kSmem = kWarps * kWarpRing;
  static_assert(kSlots * 32 == kKeys * kChunks, "whole copies per lane");
  static_assert(kWarps * kMaxG * (DMAX + 2) * 4 <= kSmem,
                "the warps' merge fits over the rings");
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int* __restrict__ lengths, bf16* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ tickets,
                        int S, int Hkv, int G, int D, float scale, int splits,
                        int keys_per_split) {
  using C = MmaCfg<DMAX>;
  extern __shared__ __align__(128) unsigned char smem[];
  Split sp;
  if (!open_split(lengths, out, S, Hkv, G, D, keys_per_split, &sp)) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gr = lane >> 2;               // fragment row: query head g
  const int tq = lane & 3;                // fragment column pair
  const long long row_stride = (long long)Hkv * D;
  const bf16* kb = k + (long long)sp.b * S * row_stride + (long long)sp.h * D;
  const bf16* vb = v + (long long)sp.b * S * row_stride + (long long)sp.h * D;
  const uint32_t ring = smem_addr(smem + warp * C::kWarpRing);

  // the query rows as A fragments, for the whole split: row gr, columns
  // 16 ks + 2 tq (+1) and 16 ks + 8 + 2 tq (+1); rows past G are zero
  uint32_t qa[C::kKS][2];
  const bf16* qrow = q + ((long long)sp.pair * G + gr) * D;
#pragma unroll
  for (int ks = 0; ks < C::kKS; ++ks)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = ks * 16 + hf * 8 + 2 * tq;
      qa[ks][hf] = gr < G && col < D ? *reinterpret_cast<const uint32_t*>(qrow + col) : 0u;
    }

  // this lane's copies: the same (row, chunk) slots in every tile; chunk
  // c of row r sits at chunk c ^ (r & 7), so ldmatrix's 8 rows hit 8 banks
  const int cpr = D / 8;
  int soff[C::kSlots], srow[C::kSlots];
  long long goff[C::kSlots];
#pragma unroll
  for (int i = 0; i < C::kSlots; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / C::kChunks, c = idx % C::kChunks;
    srow[i] = c < cpr ? r : kNoRow;
    soff[i] = r * C::kRowBytes + ((c ^ (r & 7)) << 4);
    goff[i] = r * row_stride + c * 8;
  }
  const int ntiles = (sp.k1 - sp.k0 + C::kKeys - 1) / C::kKeys;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int i) {               // tile warp + 4 i into stage i % 3
    if (i < mine) {
      const int t0 = sp.k0 + (warp + i * kWarps) * C::kKeys;
      copy_tile<bf16, C::kSlots>(ring + (i % C::kStages) * 2 * C::kTile,
                                 C::kTile, kb + t0 * row_stride,
                                 vb + t0 * row_stride, soff, srow, goff,
                                 sp.k1 - t0);
    } else {
      cp_async_commit();                  // empty groups keep the count
    }
  };
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) issue(i);

  const float qscale = scale * kLog2e;
  float m = kNegInf, l = 0.0f;            // row gr; l over this lane's keys
  float acc[C::kNB][2];                   // row gr, columns 8 nb + 2 tq (+1)
#pragma unroll
  for (int nb = 0; nb < C::kNB; ++nb) acc[nb][0] = acc[nb][1] = 0.0f;

  for (int i = 0; i < mine; ++i) {
    issue(i + C::kStages - 1);
    cp_async_wait<C::kStages - 1>();      // this lane's copies of tile i
    __syncwarp();                         // ... and the other lanes'
    const uint32_t kt = ring + (i % C::kStages) * 2 * C::kTile;
    const uint32_t vt = kt + C::kTile;
    const int t0 = sp.k0 + (warp + i * kWarps) * C::kKeys;

    // scores of keys 8 nb + 2 tq (+1), nb = 0, 1: Q K^T by tensor cores
    float sc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int j = 0; j < C::kKS / 2; ++j) {   // two k-steps per ldmatrix
        if (32 * j < D) {
          const int key = nb * 8 + (lane & 7);
          const int chunk = 4 * j + (lane >> 3);
          uint32_t bk[4];
          ldmatrix_x4(kt + key * C::kRowBytes + ((chunk ^ (key & 7)) << 4), bk);
          mma_rows8(sc[nb], qa[2 * j][0], qa[2 * j][1], bk[0], bk[1]);
          mma_rows8(sc[nb], qa[2 * j + 1][0], qa[2 * j + 1][1], bk[2], bk[3]);
        }
      }
    }

    float s[4], mx = kNegInf;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + (e >> 1) * 8 + 2 * tq + (e & 1);
      s[e] = key < sp.k1 ? sc[e >> 1][e & 1] * qscale : kNegInf;
      mx = fmaxf(mx, s[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = exp2f(s[e] - m_new);
    l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
#pragma unroll
    for (int nb = 0; nb < C::kNB; ++nb) {
      acc[nb][0] *= alpha;
      acc[nb][1] *= alpha;
    }

    // P V: P's f32 values as three bf16 terms; the score's C fragments
    // (keys 2 tq, 2 tq + 1 and 8 + 2 tq, 9 + 2 tq of row gr) are A's a0, a2
    uint32_t ph[2], pm[2], pl[2];
    split3(p[0], p[1], &ph[0], &pm[0], &pl[0]);
    split3(p[2], p[3], &ph[1], &pm[1], &pl[1]);
#pragma unroll
    for (int pb = 0; pb < C::kNB / 2; ++pb) {  // 16 columns per ldmatrix
      if (16 * pb < D) {
        const int key = (lane & 7) + 8 * ((lane >> 3) & 1);
        const int chunk = 2 * pb + (lane >> 4);
        uint32_t bv[4];
        ldmatrix_x4_trans(vt + key * C::kRowBytes + ((chunk ^ (key & 7)) << 4), bv);
        mma_rows8(acc[2 * pb], pl[0], pl[1], bv[0], bv[1]);
        mma_rows8(acc[2 * pb], pm[0], pm[1], bv[0], bv[1]);
        mma_rows8(acc[2 * pb], ph[0], ph[1], bv[0], bv[1]);
        if (16 * pb + 8 < D) {
          mma_rows8(acc[2 * pb + 1], pl[0], pl[1], bv[2], bv[3]);
          mma_rows8(acc[2 * pb + 1], pm[0], pm[1], bv[2], bv[3]);
          mma_rows8(acc[2 * pb + 1], ph[0], ph[1], bv[2], bv[3]);
        }
      }
    }
    __syncwarp();                         // the stage is free again
  }
  cp_async_wait<0>();
  __syncthreads();                        // every warp is done with its ring

  float* red = reinterpret_cast<float*>(smem);
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  if (gr < G) {
    float* r = red + (warp * kMaxG + gr) * (DMAX + 2);
#pragma unroll
    for (int nb = 0; nb < C::kNB; ++nb) {
      if (8 * nb < D) {
        r[8 * nb + 2 * tq] = acc[nb][0];
        r[8 * nb + 2 * tq + 1] = acc[nb][1];
      }
    }
    if (tq == 0) {
      r[DMAX] = m;
      r[DMAX + 1] = l;
    }
  }
  __syncthreads();
  finish<bf16, DMAX>(red, out, ws, tickets, sp, splits, G, D);
}

// ------------------------------------------ bf16 past D 128: the wide kernel

template <int DMAX>
struct WideCfg {
  static constexpr int kConsumers = 8;                   // warps on the tiles
  static constexpr int kProducers = 4;                   // copy warps
  static constexpr int kThreads = 32 * (kConsumers + kProducers);
  static constexpr int kStages = 12;
  static constexpr int kKeys = 16;                       // the MMA's M rows
  static constexpr int kPitch = DMAX * 2 + 16;           // bytes per row
  static constexpr int kTile = kKeys * kPitch;           // K (or V)
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kSteps = DMAX / 16;               // k-steps, m-tiles
  static constexpr int kGroup = 8;                       // value ldmatrix
  static constexpr int kChains = 4;                      // score chains
  static constexpr int kMerge = kConsumers * 32;         // merging threads
  static constexpr int kCols = DMAX / kMerge;            // d's each, per head
  static constexpr int kMaxSplits = 512;
  static constexpr int kQ = kMaxG * kPitch;            // the query rows
  static constexpr int kSmem = kRing + kQ + 2 * kStages * 8;  // + mbarriers
  // after the loop the ring and the query rows hold the warps'
  // accumulators (rows of kRedPitch floats: the stores hit distinct
  // banks), then the split merge's (m, l) of every split and as many
  // splits' accumulators as fit
  static constexpr int kRedPitch = DMAX + 4;
  static constexpr int kFree = (kRing + kQ) / 4;
  static_assert(DMAX / 8 == 32, "one 16-byte chunk of a row per copy lane");
  static_assert(kStages % kProducers == 0, "a stage's tiles: one copy warp");
  static_assert(kSteps % kGroup == 0 && kSteps % kChains == 0, "");
  static_assert(kCols * kMerge == DMAX, "");
  static_assert(kConsumers * kMaxG * kRedPitch <= kFree &&
                kMaxSplits * kMaxG * 2 + kMaxG * DMAX * 4 <= kFree,
                "room to merge");
  static_assert(kSmem + 1024 <= 232448, "one CTA an SM");
};

// After the loop: fl[warp][g][0..DMAX) holds each consumer warp's
// accumulator, wml[warp][g] its (m, l). Merge the warps; with one valid
// split store the output, else write the split's state to the workspace,
// and the last CTA of the pair merges the splits in split order: it reads
// every split's (m, l) while the first splits' accumulators are on their
// way to shared memory (cp.async, as many splits a round trip as the ring
// holds), takes each head's weights and denominator, and sums. A thread
// owns d = tid + kMerge c of every head.
template <int DMAX>
__device__ __forceinline__ void wide_finish(float* fl, const float* wml,
                                            bf16* out, float* ws,
                                            int* tickets, const Split& sp,
                                            int splits, int G, int D) {
  using C = WideCfg<DMAX>;
  __shared__ int last_ticket;
  __shared__ float wf[C::kConsumers][kMaxG];   // the warps' weights
  __shared__ float den_s[kMaxG];
  constexpr int kP = C::kRedPitch;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gd = G * D;
  const bool single = sp.nvalid == 1;
  // the workspace, in the (B * Hkv, splits, G, D + 2) floats the host
  // allots: every split's (G, D) accumulator first (16-byte aligned for
  // the merge's copies), then every split's (m, l) per head
  const float* acc_p = ws + (long long)sp.pair * splits * gd;       // [split][G D]
  float* ml_p = ws + (long long)gridDim.x * splits * gd +
                (long long)sp.pair * splits * G * 2;                // [split][g][2]
  if (tid < G) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < C::kConsumers; ++i) mx = fmaxf(mx, wml[(i * kMaxG + tid) * 2]);
    float den = 0.0f;
#pragma unroll
    for (int i = 0; i < C::kConsumers; ++i) {
      const float f = exp2f(wml[(i * kMaxG + tid) * 2] - mx);
      wf[i][tid] = f;
      den += wml[(i * kMaxG + tid) * 2 + 1] * f;
    }
    den_s[tid] = den;
    if (!single) {
      float* ml = ml_p + (blockIdx.y * G + tid) * 2;
      ml[0] = mx;
      ml[1] = den;
    }
  }
  __syncthreads();
  bf16* ob = out + (long long)sp.pair * gd;
  float* wacc = ws + ((long long)sp.pair * splits + blockIdx.y) * gd;
  if (tid < C::kMerge) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) {
          const int d = tid + c * C::kMerge;
          if (d < D) {
            float a = 0.0f;
#pragma unroll
            for (int i = 0; i < C::kConsumers; ++i)
              a += fl[(i * kMaxG + g) * kP + d] * wf[i][g];
            if (single)
              ob[g * D + d] = __float2bfloat16(a / fmaxf(den_s[g], 1e-30f));
            else
              wacc[g * D + d] = a;
          }
        }
      }
    }
  }
  if (single) return;

  // the ticket, with release (this split's state) and acquire (the other
  // splits') semantics at the GPU's scope; the barriers order the CTA's
  // other threads around thread 0's atomic
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(tickets + sp.pair) : "memory");
    last_ticket = prev == sp.nvalid - 1;
  }
  __syncthreads();
  if (!last_ticket) return;
  float* mls = fl + C::kFree - sp.nvalid * G * 2;   // [split][g][2]: weight, l
  const int chunk = (C::kFree - sp.nvalid * G * 2) / gd;
  const uint32_t stage = smem_addr(fl);
  auto fetch = [&](int s0) {              // splits s0 .. s0 + chunk - 1
    const int n = min(chunk, sp.nvalid - s0);
    const float* src = acc_p + (long long)s0 * gd;
    for (int u = tid; u < n * gd / 4; u += C::kThreads)
      cp_async16(stage + 16 * u, src + 4 * u, 16);
    cp_async_commit();
  };
  fetch(0);
  for (int i = tid; i < sp.nvalid * G * 2; i += C::kThreads) mls[i] = __ldcg(ml_p + i);
  __syncthreads();
  for (int g = warp; g < G; g += C::kThreads / 32) {
    float mx = kNegInf;
    for (int s = lane; s < sp.nvalid; s += 32) mx = fmaxf(mx, mls[(s * G + g) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float den = 0.0f;
    for (int s = lane; s < sp.nvalid; s += 32) {
      float* e = mls + (s * G + g) * 2;
      const float f = exp2f(e[0] - mx);
      e[0] = f;
      den += e[1] * f;
    }
    den = warp_sum(den);
    if (lane == 0) den_s[g] = den;
  }
  float a[kMaxG][C::kCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) a[g][c] = 0.0f;
  for (int s0 = 0; s0 < sp.nvalid; s0 += chunk) {
    if (s0) {
      __syncthreads();                    // the last chunk is read
      fetch(s0);
    }
    cp_async_wait<0>();
    __syncthreads();                      // the chunk and the weights
    const int n = min(chunk, sp.nvalid - s0);
    if (tid < C::kMerge) {
      for (int s = 0; s < n; ++s) {       // split order: the same bits
        const float* f = mls + (s0 + s) * G * 2;
        const float* x = fl + s * gd + tid;
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
#pragma unroll
          for (int c = 0; c < C::kCols; ++c)
            if (g < G && tid + c * C::kMerge < D)
              a[g][c] += x[g * D + c * C::kMerge] * f[g * 2];
      }
    }
  }
  if (tid < C::kMerge) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) {
        const int d = tid + c * C::kMerge;
        if (g < G && d < D)
          ob[g * D + d] = __float2bfloat16(a[g][c] / fmaxf(den_s[g], 1e-30f));
      }
  }
  if (tid == 0) tickets[sp.pair] = 0;     // ready for the next call
}

template <int DMAX>
__global__ void __launch_bounds__(WideCfg<DMAX>::kThreads, 1)
flash_decode_wide_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ lengths,
                         bf16* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ tickets, int S, int Hkv, int G,
                         int D, float scale, int splits,
                         int keys_per_split) {
  using C = WideCfg<DMAX>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float wml[C::kConsumers * kMaxG * 2];   // each warp's (m, l)
  Split sp;
  if (!open_split(lengths, out, S, Hkv, G, D, keys_per_split, &sp)) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t ring = smem_addr(smem);
  const uint32_t qs = ring + C::kRing;                // the query rows
  const uint32_t full = qs + C::kQ;                   // a stage has landed
  const uint32_t empty = full + 8 * C::kStages;       // ... has been read
  const int nkeys = sp.k1 - sp.k0;
  const int ntiles = (nkeys + C::kKeys - 1) / C::kKeys;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 32);        // a copy warp's lanes
      mbar_init(empty + 8 * s, 1);        // the consumer warp
    }
    mbar_fence_init();
  }
  if (warp < C::kConsumers) {
    // the query rows to shared memory (rows past G and the chunk past D
    // that the last k-step reads are zero-filled), read back by ldmatrix
    // as the score's B fragments: no register holds them between tiles
    const bf16* qb = q + (long long)sp.pair * G * D;
    for (int i = threadIdx.x; i < kMaxG * DMAX / 8; i += C::kConsumers * 32) {
      const int g = i / (DMAX / 8), c = i % (DMAX / 8);
      const bool ok = g < G && c < D / 8;
      cp_async16(qs + g * C::kPitch + c * 16, qb + (ok ? g * D + c * 8 : 0),
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }
  __syncthreads();

  if (warp >= C::kConsumers) {
    // copy warp p takes tiles p, p + kProducers, ... (one warp issues a
    // row's 16-byte chunks at ~20 B a cycle: one would cap the CTA's
    // stream). Lane c copies chunk c of each of the tile's 16 K and 16 V
    // rows; rows past the valid keys and the chunk past D that the last
    // k-step reads (D % 16 == 8) are zero-filled. Each lane arrives on
    // the stage's barrier when its copies have landed.
    const long long row_stride = (long long)Hkv * D;
    const int c = lane;
    const bool live = c < (D + 15) / 16 * 2;
    const bool data = c < D / 8;
    const long long base = ((long long)sp.b * S + sp.k0) * row_stride +
                           (long long)sp.h * D;
    const bf16* kb = k + base;
    const bf16* vb = v + base;
    const uint32_t dst = ring + c * 16;
    for (int t = warp - C::kConsumers; t < ntiles; t += C::kProducers) {
      const int st = t % C::kStages;
      if (t >= C::kStages) mbar_wait(empty + 8 * st, (t / C::kStages - 1) & 1);
      const int rows = min(C::kKeys, nkeys - t * C::kKeys);
      if (live) {
        const uint32_t sdst = dst + st * C::kStage;
        const long long t0 = (long long)t * C::kKeys * row_stride + c * 8;
#pragma unroll
        for (int r = 0; r < C::kKeys; ++r) {
          const bool ok = data && r < rows;
          const long long off = ok ? t0 + r * row_stride : 0;   // row 0 is valid memory
          cp_async16(sdst + r * C::kPitch, kb + off, ok ? 16 : 0);
          cp_async16(sdst + C::kTile + r * C::kPitch, vb + off, ok ? 16 : 0);
        }
      }
      cp_async_arrive(full + 8 * st);
    }
  }

  const int gr = lane >> 2;               // fragment row
  const int tq = lane & 3;                // fragment column pair
  float m[2] = {kNegInf, kNegInf};        // heads 2 tq, 2 tq + 1
  float l[2] = {0.0f, 0.0f};              // ... over this lane's keys
  float acc[C::kSteps][4];                // O^T: dims 16 mt + gr (+ 8)
#pragma unroll
  for (int mt = 0; mt < C::kSteps; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.0f;
  if (warp < C::kConsumers) {
    cp_async_wait<0>();                   // this thread's query chunks
    asm volatile("bar.sync 1, %0;\n" :: "n"(C::kConsumers * 32) : "memory");
    const float qscale = scale * kLog2e;
    // ldmatrix's row addresses: matrix j = lane / 8, row lane % 8. K (A of
    // the score: keys x dims): keys 8 (j & 1) + row, dims + 8 (j >> 1). V
    // (A of the value, V^T: dims x keys, by .trans): keys 8 (j >> 1) +
    // row, dims + 8 (j & 1).
    const int lrow = lane & 7, lmat = lane >> 3;
    // Q^T (B of the score: dims x heads) from the query rows: matrix j is
    // head row lrow, dims + 8 j; an x4 holds two k-steps' (b0, b1)
    const uint32_t qoff = qs + lrow * C::kPitch + lmat * 16;
    const uint32_t koff = (lrow + 8 * (lmat & 1)) * C::kPitch + (lmat >> 1) * 16;
    const uint32_t voff = C::kTile + (lrow + 8 * (lmat >> 1)) * C::kPitch +
                          (lmat & 1) * 16;

    for (int t = warp; t < ntiles; t += C::kConsumers) {
      const int st = t % C::kStages;
      // a parity wait tells two phases apart, not three: the stage's last
      // tile (t - kStages) is another warp's, and its full phase may still
      // be open when this one's is done. Wait until that tile was read
      // (then this tile's phase is the full barrier's open or last one).
      if (t >= C::kStages) mbar_wait(empty + 8 * st, (t / C::kStages - 1) & 1);
      mbar_wait(full + 8 * st, (t / C::kStages) & 1);
      const uint32_t base = ring + st * C::kStage;
      const int rows = nkeys - t * C::kKeys;   // valid keys: all if >= 16

      // scores S^T = K Q^T: keys gr, gr + 8 (rows) x heads 2 tq (+1); a
      // group's ldmatrix first, then its MMAs, one per chain
      float sc[C::kChains][4];
#pragma unroll
      for (int i = 0; i < C::kChains; ++i)
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < C::kSteps; k0 += C::kChains) {
        if (16 * k0 < D) {
          uint32_t a[C::kChains][4], b[C::kChains][2];
#pragma unroll
          for (int i = 0; i < C::kChains; i += 2) {
            uint32_t x[4];
            ldmatrix_x4(qoff + (k0 + i) * 32, x);
            b[i][0] = x[0];
            b[i][1] = x[1];
            b[i + 1][0] = x[2];
            b[i + 1][1] = x[3];
          }
#pragma unroll
          for (int i = 0; i < C::kChains; ++i)
            if (16 * (k0 + i) < D) ldmatrix_x4(base + koff + (k0 + i) * 32, a[i]);
#pragma unroll
          for (int i = 0; i < C::kChains; ++i)
            if (16 * (k0 + i) < D) mma16816(sc[i], a[i], b[i][0], b[i][1]);
        }
      }
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = ((sc[0][e] + sc[1][e]) + (sc[2][e] + sc[3][e])) * qscale;
        if (gr + 8 * (e >> 1) >= rows) s[e] = kNegInf;
      }
      float alpha[2], p[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {       // head 2 tq + j: 8 lanes, 16 keys
        float mx = fmaxf(s[j], s[j + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
        const float m_new = fmaxf(m[j], mx);
        alpha[j] = exp2f(m[j] - m_new);
        m[j] = m_new;
        p[j] = exp2f(s[j] - m_new);
        p[j + 2] = exp2f(s[j + 2] - m_new);
        l[j] = l[j] * alpha[j] + (p[j] + p[j + 2]);
      }
      if (__any_sync(kFull, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int mt = 0; mt < C::kSteps; ++mt) {
          acc[mt][0] *= alpha[0];
          acc[mt][1] *= alpha[1];
          acc[mt][2] *= alpha[0];
          acc[mt][3] *= alpha[1];
        }
      }

      // P^T as the value's B fragments: the score's C fragments of keys
      // 0-7 and 8-15 (row = key, columns = heads), each term transposed
      uint32_t ph[2], pm[2], pl[2];
      split3(p[0], p[1], &ph[0], &pm[0], &pl[0]);
      split3(p[2], p[3], &ph[1], &pm[1], &pl[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ph[i] = movmatrix_trans(ph[i]);
        pm[i] = movmatrix_trans(pm[i]);
        pl[i] = movmatrix_trans(pl[i]);
      }
      // O^T += V^T P^T: a group's ldmatrix first, then its MMAs term by
      // term, so that an accumulator's three MMAs are kGroup apart. V rows
      // past the valid keys were zero-filled: 0 x p, never 0 x NaN.
#pragma unroll
      for (int m0 = 0; m0 < C::kSteps; m0 += C::kGroup) {
        if (16 * m0 < D) {
          uint32_t a[C::kGroup][4];
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i)
            if (16 * (m0 + i) < D) ldmatrix_x4_trans(base + voff + (m0 + i) * 32, a[i]);
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i)
            if (16 * (m0 + i) < D) mma16816(acc[m0 + i], a[i], pl[0], pl[1]);
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i)
            if (16 * (m0 + i) < D) mma16816(acc[m0 + i], a[i], pm[0], pm[1]);
#pragma unroll
          for (int i = 0; i < C::kGroup; ++i)
            if (16 * (m0 + i) < D) mma16816(acc[m0 + i], a[i], ph[0], ph[1]);
        }
      }
      __syncwarp();                       // every lane has read the stage
      if (lane == 0) mbar_arrive(empty + 8 * st);
    }
  }
  __syncthreads();                        // the ring is read and idle

  float* fl = reinterpret_cast<float*>(smem);
  if (warp < C::kConsumers) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l[j] += __shfl_xor_sync(kFull, l[j], 4);
      l[j] += __shfl_xor_sync(kFull, l[j], 8);
      l[j] += __shfl_xor_sync(kFull, l[j], 16);
      const int g = 2 * tq + j;
      if (g < G) {
        float* r = fl + (warp * kMaxG + g) * C::kRedPitch;
#pragma unroll
        for (int mt = 0; mt < C::kSteps; ++mt) {
          const int d = 16 * mt + gr;
          if (d < D) r[d] = acc[mt][j];
          if (d + 8 < D) r[d + 8] = acc[mt][j + 2];
        }
        if (gr == 0) {
          wml[(warp * kMaxG + g) * 2] = m[j];
          wml[(warp * kMaxG + g) * 2 + 1] = l[j];
        }
      }
    }
  }
  __syncthreads();
  wide_finish<DMAX>(fl, wml, out, ws, tickets, sp, splits, G, D);
}

// --------------------------------------------------------- f32: CUDA cores

template <int DMAX>
struct SimtCfg {
  static constexpr int kStages = 4;
  static constexpr int kE = 4;                           // f32 per chunk
  static constexpr int kChunks = DMAX / kE;
  static constexpr int kRowBytes = DMAX * 4;
  static constexpr int kKeys = 2048 / kRowBytes;         // per warp tile
  static constexpr int kTile = kKeys * kRowBytes;
  static constexpr int kLK = 32 / kKeys;                 // lanes per key
  static constexpr int kCPL = kChunks / kLK;             // chunks per lane
  static constexpr int kSlots = kKeys * kChunks / 32;
  static constexpr int kCols = DMAX / 32;                // value columns
  // rows sharing a quarter-warp's 16-byte reads in the score
  static constexpr int kSwzRows = kLK < 8 ? 8 / kLK : 1;
  static constexpr int kWarpRing = kStages * 2 * kTile;
  static constexpr int kSmem = kWarps * kWarpRing + kMaxG * DMAX * 4;
  static_assert(kKeys * kLK == 32 && kCPL * kLK == kChunks, "lanes per key");
  static_assert(kSlots * 32 == kKeys * kChunks, "whole copies per lane");
  static_assert(kWarps * kMaxG * (DMAX + 2) * 4 <= kWarps * kWarpRing,
                "the warps' merge fits over the rings");
};

// chunk c of row r sits at chunk c ^ swz(r): a quarter-warp's score reads
// (kSwzRows keys, kLK consecutive chunks each) hit 8 distinct bank groups
template <int DMAX>
__device__ __forceinline__ int swz(int r) {
  using C = SimtCfg<DMAX>;
  return (r % C::kSwzRows) * C::kLK;
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ lengths, float* __restrict__ out,
                         float* __restrict__ ws, int* __restrict__ tickets,
                         int S, int Hkv, int G, int D, float scale, int splits,
                         int keys_per_split) {
  using C = SimtCfg<DMAX>;
  extern __shared__ __align__(128) unsigned char smem[];
  Split sp;
  if (!open_split(lengths, out, S, Hkv, G, D, keys_per_split, &sp)) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_stride = (long long)Hkv * D;
  const float* kb = k + (long long)sp.b * S * row_stride + (long long)sp.h * D;
  const float* vb = v + (long long)sp.b * S * row_stride + (long long)sp.h * D;
  const int cpr = D / C::kE;

  unsigned char* ring = smem + warp * C::kWarpRing;
  const uint32_t ring_s = smem_addr(ring);
  float* q_s = reinterpret_cast<float*>(smem + kWarps * C::kWarpRing);
  const float* qb = q + (long long)sp.pair * G * D;
  const float qscale = scale * kLog2e;
  for (int i = tid; i < kMaxG * DMAX; i += kThreads) {
    const int g = i / DMAX, d = i - g * DMAX;
    q_s[i] = (g < G && d < D) ? qb[g * D + d] * qscale : 0.0f;
  }

  int soff[C::kSlots], srow[C::kSlots];
  long long goff[C::kSlots];
#pragma unroll
  for (int i = 0; i < C::kSlots; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / C::kChunks, c = idx % C::kChunks;
    srow[i] = c < cpr ? r : kNoRow;
    soff[i] = r * C::kRowBytes + ((c ^ swz<DMAX>(r)) << 4);
    goff[i] = r * row_stride + c * C::kE;
  }
  const int ntiles = (sp.k1 - sp.k0 + C::kKeys - 1) / C::kKeys;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int i) {               // tile warp + 4 i into stage i % 4
    if (i < mine) {
      const int t0 = sp.k0 + (warp + i * kWarps) * C::kKeys;
      copy_tile<float, C::kSlots>(ring_s + (i % C::kStages) * 2 * C::kTile,
                                  C::kTile, kb + t0 * row_stride,
                                  vb + t0 * row_stride, soff, srow, goff,
                                  sp.k1 - t0);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) issue(i);
  __syncthreads();                        // q_s is written

  float m[kMaxG], l[kMaxG], acc[kMaxG][C::kCols];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[g][c] = 0.0f;
  }
  const int kk = lane / C::kLK;           // score: this lane's key
  const int lk = lane % C::kLK;           // ... and its part of d
  const int col = lane * C::kCols;        // value: this lane's columns
  const int vbyte = col * 4;

  for (int i = 0; i < mine; ++i) {
    issue(i + C::kStages - 1);
    cp_async_wait<C::kStages - 1>();
    __syncwarp();
    const unsigned char* kt_s = ring + (i % C::kStages) * 2 * C::kTile;
    const unsigned char* vt_s = kt_s + C::kTile;
    const int t0 = sp.k0 + (warp + i * kWarps) * C::kKeys;

    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < C::kCPL; ++j) {
      const int c = lk + j * C::kLK;
      if (c < cpr) {
        const float4 kf = *reinterpret_cast<const float4*>(
            kt_s + kk * C::kRowBytes + ((c ^ swz<DMAX>(kk)) << 4));
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(q_s + g * DMAX + c * C::kE);
            s[g] = fmaf(qv.x, kf.x, s[g]);
            s[g] = fmaf(qv.y, kf.y, s[g]);
            s[g] = fmaf(qv.z, kf.z, s[g]);
            s[g] = fmaf(qv.w, kf.w, s[g]);
          }
        }
      }
    }

    const bool valid = t0 + kk < sp.k1;
    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      p[g] = 0.0f;
      if (g < G) {                        // uniform: every lane shuffles
        float x = s[g];
#pragma unroll
        for (int o = C::kLK / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
        x = valid ? x : kNegInf;
        float mx = x;
#pragma unroll
        for (int o = 16; o >= C::kLK; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = exp2f(m[g] - m_new);
        m[g] = m_new;
        p[g] = exp2f(x - m_new);
        l[g] = l[g] * alpha + (lk == 0 ? p[g] : 0.0f);
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) acc[g][c] *= alpha;
      }
    }

#pragma unroll
    for (int j = 0; j < C::kKeys; ++j) {
      float pj[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        pj[g] = g < G ? __shfl_sync(kFull, p[g], j * C::kLK) : 0.0f;
      if (col < D) {
        float vf[C::kCols];
        const int byte = (((vbyte >> 4) ^ swz<DMAX>(j)) << 4) | (vbyte & 15);
        const float* vp = reinterpret_cast<const float*>(vt_s + j * C::kRowBytes + byte);
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) vf[c] = vp[c];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
#pragma unroll
            for (int c = 0; c < C::kCols; ++c) acc[g][c] = fmaf(pj[g], vf[c], acc[g][c]);
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float lw = warp_sum(l[g]);
      float* r = red + (warp * kMaxG + g) * (DMAX + 2);
      if (col < D)
#pragma unroll
        for (int c = 0; c < C::kCols; ++c) r[col + c] = acc[g][c];
      if (lane == 0) {
        r[DMAX] = m[g];
        r[DMAX + 1] = lw;
      }
    }
  }
  __syncthreads();
  finish<float, DMAX>(red, out, ws, tickets, sp, splits, G, D);
}

// ------------------------------------------------------------------ launch

// Allow a kernel its dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int DMAX>
int launch_dmax(const T* q, const T* k, const T* v, const int* lengths, T* out,
                float* ws, int* tickets, int B, int S, int Hkv, int G, int D,
                float scale, int splits, int keys_per_split, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  const dim3 grid(B * Hkv, splits);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = MmaCfg<DMAX>::kSmem;
    err = allow_smem(flash_decode_mma_kernel<DMAX>, smem, done);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_mma_kernel<DMAX><<<grid, kThreads, smem, st>>>(
        q, k, v, lengths, out, ws, tickets, S, Hkv, G, D, scale, splits,
        keys_per_split);
  } else {
    constexpr int smem = SimtCfg<DMAX>::kSmem;
    err = allow_smem(flash_decode_simt_kernel<DMAX>, smem, done);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_decode_simt_kernel<DMAX><<<grid, kThreads, smem, st>>>(
        q, k, v, lengths, out, ws, tickets, S, Hkv, G, D, scale, splits,
        keys_per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 past D 128: the wide kernel, one CTA an SM.
int launch_wide(const bf16* q, const bf16* k, const bf16* v,
                const int* lengths, bf16* out, float* ws, int* tickets, int B,
                int S, int Hkv, int G, int D, float scale, int splits,
                int keys_per_split, cudaStream_t st) {
  using C = WideCfg<256>;
  static bool done[kMaxDevices] = {};
  if (splits > C::kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flash_decode_wide_kernel<256>, C::kSmem,
                                     done);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_wide_kernel<256><<<dim3(B * Hkv, splits), C::kThreads,
                                  C::kSmem, st>>>(
      q, k, v, lengths, out, ws, tickets, S, Hkv, G, D, scale, splits,
      keys_per_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* ws, void* tickets, int B, int S, int Hkv, int G,
           int D, float scale, int splits, int keys_per_split, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (splits < 1 || keys_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* lp = static_cast<const int*>(lengths);
  T* op = static_cast<T*>(out);
  float* wp = static_cast<float*>(ws);
  int* tp = static_cast<int*>(tickets);
  if (D <= 64)
    return launch_dmax<T, 64>(qp, kp, vp, lp, op, wp, tp, B, S, Hkv, G, D,
                              scale, splits, keys_per_split, st);
  if (D <= 128)
    return launch_dmax<T, 128>(qp, kp, vp, lp, op, wp, tp, B, S, Hkv, G, D,
                               scale, splits, keys_per_split, st);
  if constexpr (std::is_same<T, bf16>::value)
    return launch_wide(qp, kp, vp, lp, op, wp, tp, B, S, Hkv, G, D, scale,
                       splits, keys_per_split, st);
  else
    return launch_dmax<T, 256>(qp, kp, vp, lp, op, wp, tp, B, S, Hkv, G, D,
                               scale, splits, keys_per_split, st);
}

}  // namespace

extern "C" {

// q: (B, Hkv, G, D); k, v: (B, S, Hkv, D); lengths: (B,) int32; out: like q;
// ws: f32 (B * Hkv, splits, G, D + 2) (the wide kernel lays its floats out
// its own way); tickets: >= B * Hkv int32, all 0 on
// entry and on return. 1 <= G <= 8, D % 8 == 0 and D <= 256; q, k, v on a
// 16-byte boundary. Split s reads keys [s * keys_per_split, (s + 1) *
// keys_per_split); splits * keys_per_split >= S; in bf16 past D 128 at
// most WideCfg<256>::kMaxSplits splits.
int flash_decode_f32(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* ws, void* tickets,
                     int B, int S, int Hkv, int G, int D, float scale,
                     int splits, int keys_per_split, void* stream) {
  return launch<float>(q, k, v, lengths, out, ws, tickets, B, S, Hkv, G, D,
                       scale, splits, keys_per_split, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const void* lengths, void* out, void* ws, void* tickets,
                      int B, int S, int Hkv, int G, int D, float scale,
                      int splits, int keys_per_split, void* stream) {
  return launch<bf16>(q, k, v, lengths, out, ws, tickets, B, S, Hkv, G, D,
                      scale, splits, keys_per_split, stream);
}

}  // extern "C"
