// RWKV6 chunked linear-attention scan, forward only, for sm_90a.
//
// Replaces the Pallas kernel rwkv_scan_kernel in
// src/repro/kernels/rwkv_scan/kernel.py:70 (body _rwkv_body at :34).  For
// each (batch row b, head h), chunk by chunk of kCT = 64 tokens, in f32:
//   a      = cumprod(w) inside the chunk, a_prev the same shifted by one
//            (starting from 1), multiplied up in row order;
//   rq     = r * a_prev,   kd = k / a  (an IEEE division);
//   y_i    = sum_{j<i} (rq_i . kd_j) v_j + rq_i S + (sum_d r_i (u k_i)) v_i;
//   S     <- a_last * S + sum_j (kd_j * a_last)^T v_j.
// Two changes from the TPU kernel, both needed by the model's prefill: the
// scan starts from the given state (the TPU kernel starts from 0), and the
// last chunk may be ragged (T % 64 != 0, T = 1 included): its rows past T
// are neither read into the result nor written, and a_last is its last
// valid row.
//
// Layout: the model's, read in place (the TPU wrapper transposes to
// (B*H, T, hd) in HBM).  r, k, v, w and y are (B, T, H, 64), contiguous, f32
// or bf16 (one dtype; y takes it), 16-byte aligned (TMA tensor copies and
// 16-byte stores; the wrapper checks); u (H, 64) f32; the states
// (B, H, 64, 64) f32, k-dim by v-dim, 16-byte aligned.  The input state is
// read once, before the first chunk, so s_out may alias s_in.
//
// Numerics: a, rq, kd, kd * a_last and diag's products are the plain
// version's (ref.py) bit for bit; the four products are f32 fmaf chains in
// a fixed order (rq S over d then att v over j < i in one chain, att over d,
// kd^T v over j), where the plain version takes matrix products, so the two
// agree to rounding, and two calls give the same bits (no atomics).  The
// strict lower triangle is never read on or past the diagonal, which is the
// where-semantics of the Pallas body.  Under strong decay a underflows and
// kd becomes inf: the output holds inf and NaN in the same places as the
// plain version (a sum's class does not depend on its order).  -fmad=false
// (the build's flag) keeps every written a * b + c unfused; the dot products
// use fmaf explicitly.
//
// Why the products stay on the f32 SIMT units: a 3xTF32 split of kd = inf
// forms hi * b_lo with b_lo = 0 wherever b is exact in TF32, and inf * 0 is
// NaN where the plain version has +-inf.  Keeping the classes would take a
// second product path for such chunks, chosen at run time; plain f32 fmaf
// sums keep them by construction, on one path for every chunk.
//
// Bound: at the serving shape (B 8, T 2048, H 40, f32) the four products
// (the strict triangle of rq kd^T and of att v, rq S and kd^T v) and the
// elementwise work are 16.5 GFLOP on the SIMT f32 units (0.247 ms at 67
// TFLOP/s) and r, k, v, w, y and the states cross HBM once (0.85 GB, 0.254
// ms at 3.35 TB/s): bytes bind, narrowly.
//
// Design: one block of 256 threads (8 warps) per (h, b), walking the chunks
// in order with S in shared memory; 212 KB of shared memory in f32 (180 KB
// in bf16), so one block an SM and 320 blocks in three waves at the serving
// shape (two blocks an SM would need 113 KB).  Each chunk has two phases
// and two block barriers:
//  - Loads: TMA tensor copies, one 64 x 64 box an array (rows past T come
//    zero-filled), on two mbarriers: chunk c+2's w is issued as soon as the
//    chain has read c+1's, its r, k, v as soon as they are converted, so
//    every copy lands under a whole phase of products.  One thread issues
//    them; no warp waits on the memory system except at the mbarriers.
//  - The decay chain: in phase 1 one warp multiplies a = a w up over chunk
//    c+1's rows in row order (two channels a lane, eight rows' w loaded
//    ahead of their multiplies) beside the products, into A and a_last.
//  - Conversion, in phase 2 on four warps of 16 rows each, all at once:
//    rq = r a_prev, kd = k / a (IEEE division), kd a_last, v as f32 and
//    diag (a warp-shuffle sum), into the next chunk's arrays (kd a_last, v
//    and diag double-buffered: the current chunk's are read in phase 2 too).
//  - Products: an 8 x 8 register tile a lane (a 32 x 64 warp tile), fed by
//    four 16-byte shared loads of a k-major A (rq and kd stored d-major, att
//    transposed) and a row-major B (kd a_last, v, S) for 64 fmaf.  Phase 1:
//    rq S (two warps, rows 0-31 and 32-63), att only over the tiles that
//    meet the strict triangle (rows 0-31 x cols 0-31 as 8 x 4 lane tiles;
//    rows 32-63 x cols 0-63), kd^T v rows 0-31 for j < 32.  Phase 2: att v
//    for j < i only (the rows 0-31 warp 31 steps, the rows 32-63 warp 63:
//    lanes in lockstep run as long as their warp's last row, so pairing row
//    blocks inside a warp buys nothing), the rest of kd^T v, the new S.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at the serving shape:
// 0.95-1.01 ms, 25% of the bound.  A lone warp of fmaf and 16-byte shared
// loads issues about one fmaf every two cycles, and a phase lasts as long
// as its longest 64-step product: that, not the bound, sets the time
// (PERF.md section 6).
//
// Launches on the caller's stream and allocates nothing.  The entry point
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take, cudaErrorNotSupported when the driver has no tensor-map
// encoder) so the caller sees a refused launch.

#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCT = 64;          // tokens per chunk
constexpr int kHD = 64;          // head dim
constexpr int kPT = kHD + 4;     // row stride of rqT, kdT and attT (floats)
constexpr int kThreads = 256;
constexpr int kUSplit = 32;      // kd^T v rows 0-31: j < kUSplit in phase 1

// The tensor maps of w, r, k and v (the raw stage's order): (64, H, T, B)
// with a 64 x 1 x 64 x 1 box, so one copy brings one (b, h) chunk.
struct Maps {
  CUtensorMap m[4];
};

// Shared memory: the raw stage, then f32 arrays, then the two mbarriers.
template <typename T>
struct Smem {
  static constexpr size_t raw_bytes = sizeof(T) * 4 * kCT * kHD;
  static constexpr int rqT = 0;                      // [d][i]
  static constexpr int kdT = rqT + kHD * kPT;        // [d][j]
  static constexpr int attT = kdT + kHD * kPT;       // [j][i]
  static constexpr int A = attT + kCT * kPT;         // [i][d] a
  static constexpr int kdl = A + kCT * kHD;          // [2][j][d] kd * a_last
  static constexpr int V = kdl + 2 * kCT * kHD;      // [2][j][e]
  static constexpr int S = V + 2 * kCT * kHD;        // [d][e]
  static constexpr int D = S + kHD * kHD;            // [2][i] diag
  static constexpr int AL = D + 2 * kCT;             // [2][d] a_last
  static constexpr int floats = AL + 2 * kHD;
  static constexpr size_t bar = raw_bytes + sizeof(float) * floats;
  static constexpr size_t bytes = bar + 2 * sizeof(uint64_t);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// Four adjacent values, one 16-byte (f32) or 8-byte (bf16) store.
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(a);
  lo.y = __float2bfloat16_rn(b);
  hi.x = __float2bfloat16_rn(c);
  hi.y = __float2bfloat16_rn(d);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// A raw-stage mbarrier (one for w, one for r, k, v): one arrival with the
// expected bytes and its copies' completions make up a phase; phase c
// brings chunk c.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}
// Chunk rows [t0, t0 + 64) of head h, batch row b, of arrays [a0, a1)
// (0 w, 1 r, 2 k, 3 v) into the raw stage: one TMA tensor copy (64 x 64,
// rows past T zero-filled) an array, completing on bar.  One thread.
template <typename T>
__device__ __forceinline__ void issue_copies(T* raw, const CUtensorMap* maps,
                                             int a0, int a1, int h, int t0,
                                             int b, uint64_t* bar) {
  // the slots' last generic reads come before these async-proxy writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)),
               "r"(static_cast<unsigned>(sizeof(T) * (a1 - a0) * kCT * kHD))
               : "memory");
  for (int arr = a0; arr < a1; ++arr)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(smem_addr(raw + arr * kCT * kHD)),
        "l"(reinterpret_cast<uint64_t>(maps + arr)), "r"(0), "r"(h),
        "r"(t0), "r"(b), "r"(smem_addr(bar))
        : "memory");
}

// A lane's tile of a warp product: rows r + {0..3} and r + 16 + {0..3} of
// 32, columns c + {0..3} (and c + 32 + {0..3} for 8 x 8) of 32 or 64, with
// r = 4 (lane / 8), c = 4 (lane % 8).  The sums run over k in order:
// acc[ii][jj] += A[k][row ii] * B[k][col jj], one fmaf each, fed by two
// 16-byte loads of A (k-major) and one or two of B a k.
template <int NB, int LDA, int LDB>
__device__ __forceinline__ void tile_fma(float (&acc)[8][4 * NB],
                                         const float* A, const float* B,
                                         int k0, int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const float4 a0 = ld4(A + k * LDA), a1 = ld4(A + k * LDA + 16);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[4 * NB];
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const float4 b = ld4(B + k * LDB + 32 * h);
      bv[4 * h] = b.x;
      bv[4 * h + 1] = b.y;
      bv[4 * h + 2] = b.z;
      bv[4 * h + 3] = b.w;
    }
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4 * NB; ++jj)
        acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[8][N]) {
#pragma unroll
  for (int ii = 0; ii < 8; ++ii)
#pragma unroll
    for (int jj = 0; jj < N; ++jj) acc[ii][jj] = 0.0f;
}

// Named barrier of the converting warps (id 1; 0 is __syncthreads).
__device__ __forceinline__ void convert_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// a = cumprod(w) over the chunk's n rows, in row order, into A (and
// a_last into AL): one warp, a lane channels lane and lane + 32, eight
// rows' w loaded ahead of their multiplies.
template <typename T>
__device__ __forceinline__ void chain(const T* W, float* A, float* ALn,
                                      int n, int lane) {
  const int c0 = lane, c1 = lane + 32;
  float a0 = 1.0f, a1 = 1.0f;
  for (int ib = 0; ib < n; ib += 8) {
    float w0[8], w1[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {        // rows past n are zero-filled
      w0[t] = to_f32(W[(ib + t) * kHD + c0]);
      w1[t] = to_f32(W[(ib + t) * kHD + c1]);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (ib + t < n) {
        a0 = a0 * w0[t];
        a1 = a1 * w1[t];
        A[(ib + t) * kHD + c0] = a0;
        A[(ib + t) * kHD + c1] = a1;
      }
  }
  ALn[c0] = a0;
  ALn[c1] = a1;
}

// rq = r a_prev, kd = k / a, kd * a_last, diag and v as f32 for rows
// [ra, rb) (a multiple of 8 apart) of a chunk of n rows: one warp, a lane
// channels lane and lane + 32, eight rows at a time.
template <typename T>
__device__ __forceinline__ void elementwise(const T* raw, float* F,
                                            float* kdl, float* Vn, float* Dn,
                                            const float* ALn, int n, int ra,
                                            int rb, int lane, float u0,
                                            float u1) {
  const T* R = raw + kCT * kHD;
  const T* K = raw + 2 * kCT * kHD;
  const T* Vr = raw + 3 * kCT * kHD;
  const float* A = F + Smem<T>::A;
  float* rqT = F + Smem<T>::rqT;
  float* kdT = F + Smem<T>::kdT;
  const int c[2] = {lane, lane + 32};
  const float al[2] = {ALn[lane], ALn[lane + 32]};
  for (int ib = ra; ib < min(rb, n); ib += 8) {
    float rq[2][8], kd[2][8], p[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = ib + t;              // rows past n: never read
      float q[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float rv = to_f32(R[i * kHD + c[x]]);
        const float kv = to_f32(K[i * kHD + c[x]]);
        const float ap = i == 0 ? 1.0f : A[(i - 1) * kHD + c[x]];
        rq[x][t] = rv * ap;
        kd[x][t] = kv / A[i * kHD + c[x]];
        q[x] = rv * ((x == 0 ? u0 : u1) * kv);
      }
      p[t] = q[0] + q[1];                // diag_i: two channels a lane
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)     // then the warp
#pragma unroll
      for (int t = 0; t < 8; ++t)
        p[t] += __shfl_xor_sync(0xffffffffu, p[t], o);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int i = ib + t;
      if (i < n) {
        if (lane == t) Dn[i] = p[t];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          kdl[i * kHD + c[x]] = kd[x][t] * al[x];
          Vn[i * kHD + c[x]] = to_f32(Vr[i * kHD + c[x]]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int hh = 0; hh < 8; hh += 4) {
        store4(rqT + c[x] * kPT + ib + hh, rq[x][hh], rq[x][hh + 1],
               rq[x][hh + 2], rq[x][hh + 3]);
        store4(kdT + c[x] * kPT + ib + hh, kd[x][hh], kd[x][hh + 1],
               kd[x][hh + 2], kd[x][hh + 3]);
      }
  }
}

// Warp roles (a scheduler runs warps w and w + 4), chunk c:
//  phase 1 (products)              phase 2 (after one barrier)
//  0: rq S, y rows 0-31            att v rows 0-31; y
//  1: rq S, y rows 32-63           att v rows 32-63; y
//  2: kd^T v rows 0-31, j < 32     kd^T v rows 0-31, j >= 32; S rows 0-31
//  3: a of chunk c+1; w of c+2 in  kd^T v rows 32-63; S rows 32-63
//  4: -                            convert c+1 rows 0-15; r, k, v of c+2 in
//  5: -                            convert c+1 rows 16-31
//  6: att rows 0-31 x cols 0-31    convert c+1 rows 32-47
//  7: att rows 32-63 x cols 0-63   convert c+1 rows 48-63
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rwkv_scan_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ u, const float* s_in, T* y,
                 float* s_out, int seq, int nh) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);
  float* F = reinterpret_cast<float*>(smem + Smem<T>::raw_bytes);
  const float* rqT = F + Smem<T>::rqT;
  const float* kdT = F + Smem<T>::kdT;
  float* attT = F + Smem<T>::attT;
  float* S = F + Smem<T>::S;
  uint64_t* bar_w = reinterpret_cast<uint64_t*>(smem + Smem<T>::bar);
  uint64_t* bar_rkv = bar_w + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lr = 4 * (lane >> 3), lc = 4 * (lane & 7);  // a lane's tile
  const int64_t row = static_cast<int64_t>(nh) * kHD;     // one t
  const int64_t base = static_cast<int64_t>(b) * seq * row + h * kHD;
  const int64_t sbase = (static_cast<int64_t>(b) * nh + h) * kHD * kHD;
  const int nc = (seq + kCT - 1) / kCT;
  const float u0 = u[h * kHD + lane], u1 = u[h * kHD + lane + 32];
  const int ra = 16 * (warp & 3);           // warps 4-7: rows converted
  auto kdl_at = [&](int c) { return F + Smem<T>::kdl + (c & 1) * kCT * kHD; };
  auto v_at = [&](int c) { return F + Smem<T>::V + (c & 1) * kCT * kHD; };
  auto d_at = [&](int c) { return F + Smem<T>::D + (c & 1) * kCT; };
  auto al_at = [&](int c) { return F + Smem<T>::AL + (c & 1) * kHD; };

  if (tid == 0) {
    bar_init(bar_w);
    bar_init(bar_rkv);
    issue_copies(raw, maps.m, 0, 1, h, 0, b, bar_w);
    issue_copies(raw, maps.m, 1, 4, h, 0, b, bar_rkv);
  }
  for (int e = 4 * tid; e < kHD * kHD; e += 4 * kThreads)
    *reinterpret_cast<float4*>(S + e) = ld4(s_in + sbase + e);
  __syncthreads();               // the mbarriers are initialized
  if (warp == 3) {
    bar_wait(bar_w, 0);
    chain(raw, F + Smem<T>::A, al_at(0), min(kCT, seq), lane);
    __syncwarp();
    if (lane == 0 && nc > 1) issue_copies(raw, maps.m, 0, 1, h, kCT, b, bar_w);
  }
  __syncthreads();
  if (warp >= 4) {
    bar_wait(bar_rkv, 0);
    elementwise(raw, F, kdl_at(0), v_at(0), d_at(0), al_at(0), min(kCT, seq),
                ra, ra + 16, lane, u0, u1);
    convert_sync();
    if (warp == 4 && lane == 0 && nc > 1)
      issue_copies(raw, maps.m, 1, 4, h, kCT, b, bar_rkv);
  }

  float acc[8][8];               // warps 0-3: y or the new S, rows 32 (w & 1)
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * kCT, n = min(kCT, seq - c0);
    const int n1 = c + 1 < nc ? min(kCT, seq - c0 - kCT) : 0;
    const float* kdl = kdl_at(c);
    const float* V = v_at(c);
    const int r32 = 32 * (warp & 1);
    __syncthreads();             // chunk c converted

    // phase 1
    if (warp < 4) zero(acc);
    if (warp < 2) {
      tile_fma<2, kPT, kHD>(acc, rqT + r32 + lr, S + lc, 0, kHD);
    } else if (warp == 2) {
      tile_fma<2, kHD, kHD>(acc, kdl + lr, V + lc, 0, min(n, kUSplit));
    } else if (warp == 3) {
      if (n1 > 0) {
        bar_wait(bar_w, (c + 1) & 1);
        chain(raw, F + Smem<T>::A, al_at(c + 1), n1, lane);
        __syncwarp();
        if (lane == 0 && c + 2 < nc)
          issue_copies(raw, maps.m, 0, 1, h, c0 + 2 * kCT, b, bar_w);
      }
    } else if (warp == 6) {
      float att[8][4];
      zero(att);
      tile_fma<1, kPT, kPT>(att, rqT + lr, kdT + lc, 0, kHD);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* p = attT + (lc + jj) * kPT + lr;
        store4(p, att[0][jj], att[1][jj], att[2][jj], att[3][jj]);
        store4(p + 16, att[4][jj], att[5][jj], att[6][jj], att[7][jj]);
      }
    } else if (warp == 7) {
      float att[8][8];
      zero(att);
      tile_fma<2, kPT, kPT>(att, rqT + 32 + lr, kdT + lc, 0, kHD);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float* p = attT + (lc + 32 * (jj >> 2) + (jj & 3)) * kPT + 32 + lr;
        store4(p, att[0][jj], att[1][jj], att[2][jj], att[3][jj]);
        store4(p + 16, att[4][jj], att[5][jj], att[6][jj], att[7][jj]);
      }
    }
    __syncthreads();             // att and chunk c+1's a visible

    // phase 2
    if (warp < 2) {
      // att v: j < r32 for every row of the tile, then j < i only
      tile_fma<2, kPT, kHD>(acc, attT + r32 + lr, V + lc, 0, r32);
      for (int j = r32; j < r32 + 31; ++j) {
        const float4 a0 = ld4(attT + j * kPT + r32 + lr);
        const float4 a1 = ld4(attT + j * kPT + r32 + lr + 16);
        const float4 b0 = ld4(V + j * kHD + lc);
        const float4 b1 = ld4(V + j * kHD + lc + 32);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          if (j < r32 + lr + (ii & 3) + 16 * (ii >> 2)) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
          }
        }
      }
      const float* D = d_at(c);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int i = r32 + lr + (ii & 3) + 16 * (ii >> 2);
        if (i < n) {
          const float di = D[i];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float4 v4 = ld4(V + i * kHD + lc + 32 * hh);
            const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
            float out[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const float dv = di * vv[jj];
              out[jj] = acc[ii][4 * hh + jj] + dv;
            }
            store4(y + base + (c0 + i) * row + lc + 32 * hh, out[0], out[1],
                   out[2], out[3]);
          }
        }
      }
    } else if (warp < 4) {
      tile_fma<2, kHD, kHD>(acc, kdl + r32 + lr, V + lc,
                            warp == 2 ? min(n, kUSplit) : 0, n);
      const float* AL = al_at(c);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int d = r32 + lr + (ii & 3) + 16 * (ii >> 2);
        const float al = AL[d];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* sp = S + d * kHD + lc + 32 * hh;
          const float4 s4 = ld4(sp);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          float out[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float decayed = al * sv[jj];
            out[jj] = decayed + acc[ii][4 * hh + jj];
          }
          store4(sp, out[0], out[1], out[2], out[3]);
        }
      }
    } else if (n1 > 0) {
      bar_wait(bar_rkv, (c + 1) & 1);
      elementwise(raw, F, kdl_at(c + 1), v_at(c + 1), d_at(c + 1),
                  al_at(c + 1), n1, ra, ra + 16, lane, u0, u1);
      convert_sync();
      if (warp == 4 && lane == 0 && c + 2 < nc)
        issue_copies(raw, maps.m, 1, 4, h, c0 + 2 * kCT, b, bar_rkv);
    }
  }
  __syncthreads();
  for (int e = 4 * tid; e < kHD * kHD; e += 4 * kThreads)
    *reinterpret_cast<float4*>(s_out + sbase + e) = ld4(S + e);
}

template <typename T>
cudaError_t set_smem() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Smem<T>::bytes));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// x (B, T, H, 64) as a 4-d tensor (64, H, T, B), innermost first.
template <typename T>
cudaError_t make_map(CUtensorMap* m, const void* x, int B, int T_, int nh) {
  const PFN_cuTensorMapEncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {kHD, static_cast<cuuint64_t>(nh),
                              static_cast<cuuint64_t>(T_),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {sizeof(T) * kHD, sizeof(T) * kHD * nh,
                                 sizeof(T) * kHD * nh * T_};
  const cuuint32_t box[4] = {kHD, 1, kCT, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  const CUresult err = fn(
      m, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(x), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return err == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s_in, void* y, void* s_out,
                   int B, int T_, int nh, cudaStream_t stream) {
  cudaError_t err = set_smem<T>();
  if (err != cudaSuccess) return err;
  Maps maps;
  const void* xs[4] = {w, r, k, v};
  for (int i = 0; i < 4; ++i) {
    err = make_map<T>(&maps.m[i], xs[i], B, T_, nh);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nh, B);
  rwkv_scan_kernel<T><<<grid, kThreads, Smem<T>::bytes, stream>>>(
      maps, static_cast<const float*>(u), static_cast<const float*>(s_in),
      static_cast<T*>(y), static_cast<float*>(s_out), T_, nh);
  return cudaGetLastError();
}

template <typename T>
int occupancy(int* threads, int* smem_bytes) {
  if (set_smem<T>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rwkv_scan_kernel<T>, kThreads, Smem<T>::bytes) != cudaSuccess)
    return -1;
  *threads = kThreads;
  *smem_bytes = static_cast<int>(Smem<T>::bytes);
  return n;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (r, k, v, w and y); u and the states are f32.
extern "C" int rwkv_scan(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s_in,
                         void* y, void* s_out, int B, int T_, int nh, int hd,
                         int dtype, void* stream) {
  if (B < 1 || B > 65535 || T_ < 1 || nh < 1 || hd != kHD)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s_in, y, s_out, B, T_, nh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, B, T_, nh, s);
  return cudaErrorInvalidValue;
}

// The launch shape of one dtype: threads a block and dynamic shared memory
// bytes through the pointers; returns the blocks resident on one SM of the
// current card (-1 on error).  The grid is (H, B).
extern "C" int rwkv_scan_occupancy(int dtype, int* threads, int* smem_bytes) {
  if (dtype == 0) return occupancy<float>(threads, smem_bytes);
  if (dtype == 1) return occupancy<__nv_bfloat16>(threads, smem_bytes);
  return -1;
}
