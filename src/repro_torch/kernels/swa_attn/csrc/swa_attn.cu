// Flash causal sliding-window GQA attention, forward only, for sm_90a: f32
// accuracy on the tensor cores (3xTF32), loads overlapped with compute.
//
// Replaces the Pallas kernel swa_attention_kernel in
// src/repro/kernels/swa_attn/kernel.py:73 (body _swa_body at :30): for
// each query row p of each head h,
//   out[p] = softmax_k(q[p] . k[k] * hd^-0.5 over keys k in (p - w, p],
//            or [0, p] when w = 0) @ v
// with the KV head h / (nh / kv) (GQA), an online softmax over key tiles,
// masked scores set to NEG_INF = -1e30 (not -inf: a row whose first
// visited tile is wholly masked gets p = exp(0) = 1 there, and the
// correction exp(-1e30 - m) = 0 wipes it once a valid key arrives; -inf
// would give NaN) and the normalizer clamped at 1e-30, as the reference.
// q is cast to f32 and then scaled, as the Pallas body (kernel.py:50).
//
// Layout: the model's, read in place.  q and o are (B, T, nh, hd), k and v
// (B, T, kv, hd), all contiguous, f32 or bf16 (one dtype; o takes q's).
// The TPU wrapper pads hd to the 128-lane width in HBM; here hd is padded
// to HDP (32, 64 or 128) in shared memory only, with zeros, so the padded
// columns add exact zeros to every dot product and are never stored.
//
// Bound: operations.  Per allowed (query, key) pair and head the kernel
// does 2 hd flops for q.k and 2 hd for p.v: 137.5 GFLOP for llama3.2-1b's
// prefill (B 8, T 2048, 32 heads of 64, causal), 322.2 GFLOP for
// h2o-danube-3-4b's (B 2, T 4608, 32 heads of 120, window 4096).  The
// prefill computes in f32 (the reference computes bf16 x f32 projections
// in f32), and plain TF32 keeps about 3 decimal digits, too few for the
// kernel's tolerance (2e-5 * max(1, max|want|)).  On the SIMT f32 units
// (67 TFLOP/s) the bound is 2.052 / 4.809 ms; this kernel runs three TF32
// products a product instead, on the tensor cores (495 TFLOP/s dense):
// 3 x 137.5 / 3 x 322.2 GFLOP, 0.833 / 1.953 ms.  q, k, v and o cross HBM
// once (a few tens of MB, far below either).
//
// 3xTF32 (CUTLASS's "fast accurate f32"): each f32 operand x is split into
// hi = x rounded to TF32 (to nearest, ties away) and lo = x - hi, read by
// the mma as TF32 (rounded toward zero), and a . b is taken as a_lo b_hi +
// a_hi b_lo + a_hi b_hi, accumulated in f32 by the mma; the dropped a_lo
// b_lo and the rounding of lo are about 2^-21 of |a b|.
// tests/test_torch_swa_tf32x3.py emulates the design on the CPU against
// the plain version within half the tolerance (measured: under 3% of it).
// The split costs three instructions an operand; each warp splits the K
// and V values it reads (a tile is read by all 8 warps), the q fragments
// once a tile and P once.
//
// Design: one block of 256 threads (8 warps) per (128-row q tile, query
// head, batch row), heaviest tiles (the last rows, most keys) first.  The
// key loop visits only the 64-key tiles that intersect [max(0, q0 - w +
// 1), last_q], in order.
//  - K and V tiles are f32 in shared memory, double-buffered: 16-byte
//    cp.async copies fill the next tile while this one computes (bf16
//    inputs, or rows not 16-byte aligned, are loaded, converted and stored
//    by the threads instead); one __syncthreads a tile.  Rows past T are
//    zero-filled.
//  - Warp w owns q rows q0 + 16 w .. + 15, pre-scaled f32, kept as
//    mma.sync.m16n8k8 tf32 A fragments in shared memory that only the
//    owning thread reads (in registers they spill, beside the 16 x HDP
//    output and 16 x 64 score accumulators).  Q K^T: per 16 columns of hd and
//    8 keys, one 16-byte K load (the column order inside a k-step is
//    permuted alike in A and B, so a thread's four K values are adjacent),
//    split hi/lo, 2 k-steps x 3 mma.  The 16 x 64 scores stay in the
//    accumulators.
//  - Masking only on tiles that straddle, for this warp, the diagonal, the
//    window's edge or T; a tile wholly masked for the warp's 16 rows is
//    skipped (every row attends its own key, so that changes nothing).
//  - Online softmax a row: each thread holds 16 scores of rows g and g + 8
//    (g = lane / 4), max and correction over the quad by shuffles; the row
//    sums stay per thread until the end.
//  - P V: the accumulator of scores is already the A fragment of P (keys
//    permuted within each 8: the thread's keys 2t, 2t + 1 are A's columns
//    t, t + 4), split hi/lo in registers: no round trip of P through
//    shared memory.  V's B fragments come as 16-byte loads of 4 adjacent
//    columns, one for each of 4 n-tiles (the output columns are permuted
//    within each 32 so that a thread's loads are adjacent).
//  - Row strides HDP + 16 (K) and HDP + 4 (V) floats keep the 16-byte
//    loads of a quarter warp on distinct banks.
// Shared memory: 202 KB at HDP 128 (1 block, 8 warps a SM), 106 KB at HDP
// 64 (2 blocks, 16 warps).  expf, an IEEE division at the end.  The sums
// run in another order than the plain version's (einsum over 1024-key
// blocks), so the two agree to rounding, not bitwise.
//
// Launches on the caller's stream and allocates nothing.  The entry point
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;         // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo to about 2^-21 |x|.  hi is x rounded to TF32 to nearest,
// ties away from zero: cvt.rna.tf32.f32 in its integer form (add half a
// TF32 ulp to the bits, clear the 13 low ones), the same for finite x in
// two instructions, where cvt also handles NaN and Inf.  lo = x -
// hi is exact in f32 and goes to the mma as it is: a TF32 operand's 13 low
// bits are not read, so lo counts rounded toward zero.  A NaN x gives a
// NaN lo, so a NaN still reaches the product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 tile, TF32 in, f32 accumulate
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, A split (hi, lo), B fragment (b0, b1) in f32
__device__ __forceinline__ void mma3s(float* d, const uint32_t* ah,
                                      const uint32_t* al, float b0,
                                      float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

template <int HDP>
struct Tile {
  static constexpr int KS = HDP + 16;   // row stride of K (floats)
  static constexpr int VS = HDP + 4;    // row stride of V
  static constexpr int stage = kBK * (KS + VS);
  static constexpr int q = kBQ * HDP;   // the q fragments, thread-private
  static constexpr size_t bytes = sizeof(float) * (kStages * stage + q);
};

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, HDP <= 64 ? 2 : 1)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int seq, int nh,
           int kv, int hd, int window, float scale, bool vec) {
  constexpr int KS = Tile<HDP>::KS, VS = Tile<HDP>::VS;
  constexpr int NCH = HDP / 16;   // 16-column chunks of q . k
  constexpr int NDB = HDP / 32;   // 32-column blocks of p . v
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);

  const int tile = gridDim.x - 1 - blockIdx.x;       // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (nh / kv);
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw0 = q0 + 16 * warp;                    // the warp's first row
  const int qw1 = min(qw0 + 15, seq - 1);            // and its last
  const int rA = qw0 + g, rB = rA + 8;               // this thread's rows
  const int64_t q_stride = static_cast<int64_t>(nh) * hd;   // one t of q, o
  const int64_t k_stride = static_cast<int64_t>(kv) * hd;   // one t of k, v
  const T* qb = q + static_cast<int64_t>(b) * seq * q_stride + h * hd;
  const T* kb = k + static_cast<int64_t>(b) * seq * k_stride + hk * hd;
  const T* vb = v + static_cast<int64_t>(b) * seq * k_stride + hk * hd;

  if (vec && hd < HDP) {         // the padded columns stay zero
    const int pad = HDP - hd;
    for (int e = tid; e < kStages * kBK * pad; e += kThreads) {
      const int r = e / pad, d = hd + e % pad;
      float* st = sm + (r / kBK) * Tile<HDP>::stage;
      st[(r % kBK) * KS + d] = 0.0f;
      st[kBK * KS + (r % kBK) * VS + d] = 0.0f;
    }
  }

  // q fragments, in shared memory that only this thread reads (registers
  // are the scarce resource): Qf[2 c][lane] = q[rA][16 c + 4 t4 + 0..3],
  // Qf[2 c + 1][lane] the same of rB; consecutive lanes, consecutive
  // 16 bytes
  float4* const Qf = reinterpret_cast<float4*>(sm + kStages * Tile<HDP>::stage)
                     + warp * NCH * 64 + lane;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rB : rA;
      float x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 16 * c + 4 * t4 + i;
        x[i] = (r < seq && d < hd) ? to_f32(qb[r * q_stride + d]) * scale
                                   : 0.0f;
      }
      Qf[(2 * c + half) * 32] = make_float4(x[0], x[1], x[2], x[3]);
    }

  // o accumulators: n-tile (db, j) holds columns 32 db + 4 n + j, n = 0..7;
  // this thread: [0] (rA, 32 db + 8 t4 + j), [1] (rA, 32 db + 8 t4 + 4 + j),
  // [2], [3] the same of rB
  float oacc[NDB][4][4];
#pragma unroll
  for (int db = 0; db < NDB; ++db)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[db][j][e] = 0.0f;
  float mA = kNegInf, mB = kNegInf, lA = 0.0f, lB = 0.0f;

  const int last_q = min(q0 + kBQ, seq) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = kv_lo / kBK;
  const int n_tiles = last_q / kBK - kt0 + 1;

  auto load_tile = [&](int kt, int st) {
    const int k0 = kt * kBK;
    float* Ks = sm + st * Tile<HDP>::stage;
    float* Vs = Ks + kBK * KS;
    if (vec) {
      constexpr int per_row = HDP / 4;
      for (int e = tid; e < kBK * per_row; e += kThreads) {
        const int r = e / per_row, d = (e % per_row) * 4, t = k0 + r;
        if (d < hd) {
          const bool in = t < seq;
          const int64_t off = static_cast<int64_t>(in ? t : 0) * k_stride + d;
          cp_async16(Ks + r * KS + d, reinterpret_cast<const float*>(kb) + off,
                     in);
          cp_async16(Vs + r * VS + d, reinterpret_cast<const float*>(vb) + off,
                     in);
        }
      }
    } else {
      for (int e = tid; e < kBK * HDP; e += kThreads) {
        const int r = e / HDP, d = e % HDP, t = k0 + r;
        const bool in = t < seq && d < hd;
        Ks[r * KS + d] = in ? to_f32(kb[t * k_stride + d]) : 0.0f;
        Vs[r * VS + d] = in ? to_f32(vb[t * k_stride + d]) : 0.0f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(kt0 + s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();             // tile i landed; tile i - 1 is consumed
    {
      const int nx = i + kStages - 1;
      if (nx < n_tiles) load_tile(kt0 + nx, nx % kStages);
      cp_async_commit();
    }
    const int k0 = (kt0 + i) * kBK;
    // skip a tile no row of this warp attends
    if (qw0 >= seq || k0 > qw1 || (window > 0 && k0 + kBK - 1 <= qw0 - window))
      continue;
    const bool masked = k0 + kBK - 1 > qw0 || k0 + kBK > seq ||
                        (window > 0 && k0 <= qw1 - window);
    const float* Ks = sm + (i % kStages) * Tile<HDP>::stage;
    const float* Vs = Ks + kBK * KS;

    // S = Q K^T: n-tile n holds keys k0 + 8 n + 2 t4 + {0, 1} of rows rA
    // ([0], [1]) and rB ([2], [3])
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float4 xa = Qf[2 * c * 32], xb = Qf[(2 * c + 1) * 32];
      const float qa[4] = {xa.x, xa.y, xa.z, xa.w};
      const float qb4[4] = {xb.x, xb.y, xb.z, xb.w};
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        // k-step ks: A columns t4, t4 + 4 are q columns 4 t4 + 2 ks + {0, 1}
        split(qa[2 * ks], ah[ks][0], al[ks][0]);
        split(qb4[2 * ks], ah[ks][1], al[ks][1]);
        split(qa[2 * ks + 1], ah[ks][2], al[ks][2]);
        split(qb4[2 * ks + 1], ah[ks][3], al[ks][3]);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 kf = *reinterpret_cast<const float4*>(
            &Ks[(8 * n + g) * KS + 16 * c + 4 * t4]);
        mma3s(s[n], ah[0], al[0], kf.x, kf.y);
        mma3s(s[n], ah[1], al[1], kf.z, kf.w);
      }
    }

    if (masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t4 + (e & 1);
          const int qp = e < 2 ? rA : rB;
          const bool ok =
              kp < seq && kp <= qp && (window <= 0 || kp > qp - window);
          if (!ok) s[n][e] = kNegInf;
        }
    }

    // online softmax of rows rA and rB over the quad
    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mxA = fmaxf(mxA, fmaxf(s[n][0], s[n][1]));
      mxB = fmaxf(mxB, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxA = fmaxf(mxA, __shfl_xor_sync(kFull, mxA, off));
      mxB = fmaxf(mxB, __shfl_xor_sync(kFull, mxB, off));
    }
    const float nA = fmaxf(mA, mxA), nB = fmaxf(mB, mxB);
    const float cA = expf(mA - nA), cB = expf(mB - nB);
    mA = nA;
    mB = nB;
    float sumA = 0.0f, sumB = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - nA);
      s[n][1] = expf(s[n][1] - nA);
      s[n][2] = expf(s[n][2] - nB);
      s[n][3] = expf(s[n][3] - nB);
      sumA += s[n][0] + s[n][1];
      sumB += s[n][2] + s[n][3];
    }
    lA = lA * cA + sumA;
    lB = lB * cB + sumB;
#pragma unroll
    for (int db = 0; db < NDB; ++db)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        oacc[db][j][0] *= cA;
        oacc[db][j][1] *= cA;
        oacc[db][j][2] *= cB;
        oacc[db][j][3] *= cB;
      }

    // O += P V: k-step n is keys k0 + 8 n .. + 7; A column t4 is key
    // 8 n + 2 t4 (s[n][0] of rA, s[n][2] of rB), column t4 + 4 key
    // 8 n + 2 t4 + 1 (s[n][1], s[n][3])
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float pa[4] = {s[n][0], s[n][2], s[n][1], s[n][3]};
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(pa[e], ph[e], pl[e]);
      const float* v0 = &Vs[(8 * n + 2 * t4) * VS + 4 * g];
#pragma unroll
      for (int db = 0; db < NDB; ++db) {
        const float4 x = *reinterpret_cast<const float4*>(v0 + 32 * db);
        const float4 y = *reinterpret_cast<const float4*>(v0 + VS + 32 * db);
        mma3s(oacc[db][0], ph, pl, x.x, y.x);
        mma3s(oacc[db][1], ph, pl, x.y, y.y);
        mma3s(oacc[db][2], ph, pl, x.z, y.z);
        mma3s(oacc[db][3], ph, pl, x.w, y.w);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lA += __shfl_xor_sync(kFull, lA, off);
    lB += __shfl_xor_sync(kFull, lB, off);
  }
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
  T* ob = o + static_cast<int64_t>(b) * seq * q_stride + h * hd;
#pragma unroll
  for (int db = 0; db < NDB; ++db)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d0 = 32 * db + 8 * t4 + j, d1 = d0 + 4;
      T* oA = ob + rA * q_stride;
      T* oB = ob + rB * q_stride;
      if (rA < seq) {
        if (d0 < hd) store(&oA[d0], __fdiv_rn(oacc[db][j][0], dA));
        if (d1 < hd) store(&oA[d1], __fdiv_rn(oacc[db][j][1], dA));
      }
      if (rB < seq) {
        if (d0 < hd) store(&oB[d0], __fdiv_rn(oacc[db][j][2], dB));
        if (d1 < hd) store(&oB[d1], __fdiv_rn(oacc[db][j][3], dB));
      }
    }
}

template <typename T, int HDP>
cudaError_t set_smem() {
  static bool done = false;
  if (!done) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tile<HDP>::bytes));
    if (err != cudaSuccess) return err;
    done = true;
  }
  return cudaSuccess;
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int T_, int nh, int kv, int hd, int window,
                   float scale, cudaStream_t stream) {
  const cudaError_t err = set_smem<T, HDP>();
  if (err != cudaSuccess) return err;
  // 16-byte copies: f32, hd a multiple of 4 and the rows aligned (the row
  // stride is kv * hd floats)
  const bool vec = sizeof(T) == 4 && hd % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((T_ + kBQ - 1) / kBQ, nh, B);
  swa_kernel<T, HDP><<<grid, kThreads, Tile<HDP>::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_, nh, kv, hd, window,
      scale, vec);
  return cudaGetLastError();
}

template <typename T, int HDP>
int occupancy() {
  if (set_smem<T, HDP>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, swa_kernel<T, HDP>, kThreads, Tile<HDP>::bytes) != cudaSuccess)
    return -1;
  return n;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int T_, int nh, int kv, int hd, int window,
                     float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, T_, nh, kv, hd, window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, T_, nh, kv, hd, window, scale, stream);
  return launch<T, 128>(q, k, v, o, B, T_, nh, kv, hd, window, scale, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and o).  scale: hd^-0.5 as an f32.
extern "C" int swa_attention(const void* q, const void* k, const void* v,
                             void* o, int B, int T_, int nh, int kv, int hd,
                             int window, int dtype, float scale,
                             void* stream) {
  if (B < 1 || T_ < 1 || kv < 1 || nh % kv || hd < 1 || hd > 128 ||
      nh > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, T_, nh, kv, hd, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, T_, nh, kv, hd, window,
                                   scale, s);
  return cudaErrorInvalidValue;
}

// Blocks of 256 threads resident a SM for hd's padded width (f32), or -1.
extern "C" int swa_attention_occupancy(int hd) {
  if (hd <= 32) return occupancy<float, 32>();
  if (hd <= 64) return occupancy<float, 64>();
  return occupancy<float, 128>();
}
