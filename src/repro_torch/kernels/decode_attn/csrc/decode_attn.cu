// One-token GQA decode attention over a position-tagged ring KV cache, for
// sm_90a: the serving hot loop.  Flash-decoding: the cache is split over
// blocks, and the splits are combined in the same launch.
//
// Replaces the Pallas kernel decode_attention_kernel in
// src/repro/kernels/decode_attn/kernel.py:60 (body _decode_body at :26):
// for each batch row b and query head h, with qp = q_pos[b],
//   out[h] = softmax_c(q[h] . k[c] * hd^-0.5 over the slots c whose
//            position pos[c] is >= 0 (filled), <= qp and, with w > 0,
//            > qp - w) @ v
// with the KV head h / (nh / kv).  Slots carry their global positions (-1
// = empty), so the ring's rotation and the window's eviction need no
// special handling: the mask is computed from pos alone, and the answer
// does not depend on where in the ring a slot lies.  Masked scores are
// NEG_INF = -1e30 and the running maxima start there; the normalizer is
// clamped at 1e-30.  q is cast to f32, then scaled (kernel.py:35).
//
// Layout: q and o (B, 1, nh, hd) in f32 or bf16; k and v one layer's cache
// (B, C, kv, hd), read in place in their own dtype (bf16 on the serving
// path, f32 allowed); pos (B, C) and q_pos (B,) int32.  All contiguous.
// hd <= 128 is padded to HDP (32, 64 or 128) in shared memory only, with
// zeros; nh / kv <= 8.
//
// Bound: HBM bytes.  A decode step reads the whole cache of the layer (k
// and v, 2 * B * C * kv * hd elements, and pos) once; q and o are small:
// 34.28 MB for llama3.2-1b at batch 8 and C = 2080 (bf16), 10.2 us at
// 3.35 TB/s; 31.55 MB, 9.4 us for h2o-danube-3-4b at batch 2, C = 4096.
// The flops (4 hd per slot and query head) are 8x fewer per byte than the
// f32 units could do.
//
// Design.  One block of 128 threads per (split, KV head, batch row): the
// wrapper cuts the C slots into n_split splits of L slots (L a multiple of
// 64, chosen so that the grid fills the card), so a small batch still
// streams its cache on every SM.  Each of the four warps walks its own
// 16-slot chunks of the split (chunk i of the split goes to warp i % 4)
// with its own online softmax, and no barrier stops the block's main loop:
//  - the block reads the split's positions into shared memory first, with
//    q, so no warp waits on a position in its loop; a chunk with no
//    attended slot is not loaded (except each warp's first, issued before
//    the positions arrive) and leaves the warp's (m, l, acc) as they were;
//  - K and V rows reach shared memory as raw bf16 (or f32) by 16-byte
//    cp.async copies, double-buffered per warp: the next chunk loads
//    while this one computes (a third stage measured no faster).  Rows
//    carry one 16-byte vector of pad, so the 8 lanes of a quarter warp
//    that read one column of 8 rows hit 8 distinct bank groups;
//  - the G <= 8 scores of a slot are computed in two lanes, each dotting
//    half the columns of the K row with every head's pre-scaled f32 query
//    (in shared memory: all lanes of a quarter warp read the same 16
//    bytes), G independent chains of HDP / 2 fmaf; one shuffle adds the
//    halves, so lanes s and s + 16 both hold slot s's scores.  G is a
//    template parameter (rounded up to 1, 2, 4 or 8): the heads' chains
//    and shuffles interleave, where a branch a head kept them apart;
//  - softmax of each head over the chunk by shuffles within the 16 lanes;
//    the probabilities go to shared memory, and P @ V has lane j own output
//    columns [j HDP / 32, (j + 1) HDP / 32) of every head, reading each
//    slot's probabilities with one broadcast load (two at G > 4).
// At the end of the split the four warps' (m, l, acc) merge in warp order
// through shared memory into the block's partial, written to a scratch
// tensor (f32: m and l a head, acc a head and column).  Then, after
// __threadfence(), the block bumps its (b, KV head)'s arrival counter; the
// block that arrives last merges the n_split partials in split order
// 0..n-1 (not in arrival order, so the output is the same bits on every
// run), writes o in q's dtype and resets the counter to 0.  A chunk or
// split with no attended slot gives m = -1e30, l = 0, acc = 0: its weight
// exp(-1e30 - M) is 0 once any split holds a slot, and a row with no
// attended slot at all gives 0.  fmaf in the dot products (the build
// passes -fmad=false), expf, an IEEE division at the end.  The sums run in
// another order than the plain version's (einsum over 1024-slot blocks),
// so the two agree to rounding.
//
// Launches on the caller's stream and allocates nothing: the caller gives
// the scratch (B * kv * n_split * G * (hd + 2) floats) and the counters
// (B * kv int32, zero before the launch; zero again after it).  The entry
// point returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it
// does not take) so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;       // slots a warp takes per pipeline stage
constexpr int kStages = 2;       // chunks in flight a warp, this one included
constexpr int kMaxG = 8;         // query heads per KV head
constexpr int kMaxSplit = 256;
constexpr int kMaxL = 4096;      // slots a split, at most
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive elements of T (N * sizeof(T) a multiple of 16 bytes or a
// power of two below, aligned to min(16, N * sizeof(T))) in loads of up to
// 16 bytes, converted to f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float* out) {
  constexpr int B = N * sizeof(T) < 16 ? N * sizeof(T) : 16;
  constexpr int M = B / sizeof(T);             // elements a load
  struct alignas(B) Pack { T x[M]; };
#pragma unroll
  for (int j = 0; j < N / M; ++j) {
    const Pack pk = reinterpret_cast<const Pack*>(p)[j];
#pragma unroll
    for (int i = 0; i < M; ++i) out[j * M + i] = to_f32(pk.x[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// Row stride of the staged K and V (elements): one 16-byte vector of pad,
// so the lanes that read one column of 8 rows hit 8 distinct bank groups.
template <typename TKV, int HDP>
__host__ __device__ constexpr int row_stride() {
  return HDP + 16 / sizeof(TKV);
}

// Dynamic shared memory for splits of L slots: q, the probabilities, the
// split's positions, then the stages (reused by the merges).
template <typename TKV, int HDP>
constexpr size_t smem_bytes(int L) {
  const size_t fixed = sizeof(float) * kMaxG * (HDP + kWarps * kChunk) +
                       sizeof(int) * static_cast<size_t>(L);
  const size_t stages = sizeof(TKV) * kWarps * kStages * 2 * kChunk *
                        row_stride<TKV, HDP>();
  const size_t merge = sizeof(float) * kWarps * kMaxG * (HDP + 2);
  const size_t combine = sizeof(float) * 3 * kMaxSplit * kMaxG;
  size_t m = stages > merge ? stages : merge;
  return fixed + (m > combine ? m : combine);
}

// GP: the query heads of a KV head, G, rounded up to 1, 2, 4 or 8, so that
// the heads' chains unroll without a branch each (padded heads have zero
// queries and are never written).
template <typename TKV, int HDP, int GP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ pos,
              const int* __restrict__ q_pos, void* __restrict__ o,
              bool q_bf16, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int* __restrict__ counters, int C,
              int nh, int kv, int hd, int window, float scale, int L,
              bool vec) {
  constexpr int E = 16 / sizeof(TKV);   // elements of a 16-byte vector
  constexpr int KS = row_stride<TKV, HDP>();
  constexpr int HALF = HDP / 2;         // columns of a score a lane sums
  constexpr int DPL = HDP / 32;         // output columns a lane
  constexpr int ROW = kChunk * KS;      // elements of a chunk's K (or V)
  static_assert(HALF % E == 0 && kChunk == 16, "layout");
  extern __shared__ float4 smem4[];
  float* const Qs = reinterpret_cast<float*>(smem4);   // (kMaxG, HDP)
  float* const Ps = Qs + kMaxG * HDP;                  // (kWarps, 16, GP)
  int* const Pos = reinterpret_cast<int*>(Ps + kWarps * kChunk * kMaxG);
  float* const after = reinterpret_cast<float*>(Pos + L);  // stages, merges

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = nh / kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = lane & (kChunk - 1);   // lanes 16-31 mirror 0-15
  const int half = lane >> 4;
  const int qp = q_pos[b];
  const int64_t slot_stride = static_cast<int64_t>(kv) * hd;
  const TKV* kb = k + static_cast<int64_t>(b) * C * slot_stride + hk * hd;
  const TKV* vb = v + static_cast<int64_t>(b) * C * slot_stride + hk * hd;
  const int* pb = pos + static_cast<int64_t>(b) * C;
  TKV* const wbuf = reinterpret_cast<TKV*>(after) + warp * kStages * 2 * ROW;
  float* const Pw = Ps + warp * kChunk * GP;

  if (vec && hd < HDP) {         // the padded columns stay zero
    const int pad = HDP - hd;
    for (int e = lane; e < kStages * 2 * kChunk * pad; e += 32)
      wbuf[(e / pad) * KS + hd + e % pad] = zero<TKV>();
  }

  const int s0 = split * L;
  const int s1 = min(s0 + L, C);
  const int n_chunks = (s1 - s0 + kChunk - 1) / kChunk;
  const int my_n = warp < n_chunks ? (n_chunks - warp + kWarps - 1) / kWarps
                                   : 0;
  auto chunk_slot = [&](int i) { return s0 + (i * kWarps + warp) * kChunk; };
  auto position = [&](int i) {   // of this lane's slot of the warp's chunk i
    if (i >= my_n) return -1;
    const int c = chunk_slot(i) + slot;
    return c < s1 ? Pos[c - s0] : -1;
  };
  auto attended = [&](int kp) {
    return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
  };
  auto issue = [&](int i, int st) {   // chunk i's K and V rows to stage st
    TKV* Ks = wbuf + st * 2 * ROW;
    TKV* Vs = Ks + ROW;
    const int c0 = chunk_slot(i);
    if (vec) {
      constexpr int NC = HDP / E;
      for (int e = lane; e < kChunk * NC; e += 32) {
        const int r = e / NC, d = (e % NC) * E, c = c0 + r;
        if (d < hd) {
          const bool in = c < s1;
          const int64_t off = static_cast<int64_t>(in ? c : c0) * slot_stride
                              + d;
          cp_async16(Ks + r * KS + d, kb + off, in);
          cp_async16(Vs + r * KS + d, vb + off, in);
        }
      }
    } else {
      for (int e = lane; e < kChunk * HDP; e += 32) {
        const int r = e / HDP, d = e % HDP, c = c0 + r;
        const bool in = c < s1 && d < hd;
        Ks[r * KS + d] = in ? kb[c * slot_stride + d] : zero<TKV>();
        Vs[r * KS + d] = in ? vb[c * slot_stride + d] : zero<TKV>();
      }
    }
  };

  // The first chunk loads before its positions are known (they would cost
  // a round trip first); meanwhile the block reads the split's positions
  // and q into shared memory, in one round trip.  Every later chunk loads
  // only if a slot of it is attended.
  if (my_n > 0) issue(0, 0);
  cp_async_commit();
  for (int r = tid; r < s1 - s0; r += kThreads) Pos[r] = pb[s0 + r];
  {
    const int64_t q0 = (static_cast<int64_t>(b) * nh + hk * G) * hd;
    for (int e = tid; e < kMaxG * HDP; e += kThreads) {
      const int g = e / HDP, d = e % HDP;
      float x = 0.0f;
      if (g < G && d < hd)
        x = q_bf16
                ? to_f32(static_cast<const __nv_bfloat16*>(q)[q0 + g * hd + d])
                : static_cast<const float*>(q)[q0 + g * hd + d];
      Qs[e] = x * scale;
    }
  }
  __syncthreads();
  // kp[j]: this lane's position in chunk i + j; ld[j]: chunk i + j was
  // loaded
  int kp[kStages];
  bool ld[kStages - 1];
#pragma unroll
  for (int j = 0; j < kStages; ++j) kp[j] = position(j);
  ld[0] = __any_sync(kFull, attended(kp[0]));
#pragma unroll
  for (int j = 1; j < kStages - 1; ++j) {
    ld[j] = __any_sync(kFull, attended(kp[j]));
    if (ld[j]) issue(j, j);
    cp_async_commit();
  }

  float m[GP], l[GP], acc[GP][DPL];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
  }

  for (int i = 0; i < my_n; ++i) {
    const int st = i % kStages;
    const int nx = i + kStages - 1;       // into the stage chunk i - 1 left
    const bool ld_nx = __any_sync(kFull, attended(kp[kStages - 1]));
    if (ld_nx) issue(nx, nx % kStages);
    cp_async_commit();
    const int kp_new = position(i + kStages);
    if (ld[0]) {
      cp_async_wait<kStages - 1>();     // chunk i has landed
      __syncwarp();
      const TKV* Ks = wbuf + st * 2 * ROW;
      const TKV* Vs = Ks + ROW;
      // scores: lane (slot, half) dots half the columns of its slot's K
      // row with every head's query; one shuffle adds the two halves
      float s[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) s[g] = 0.0f;
      const TKV* kr = Ks + slot * KS + half * HALF;
      const float* qh = Qs + half * HALF;
#pragma unroll
      for (int c = 0; c < HALF; c += E) {
        float kx[E];
        load_f32<TKV, E>(kr + c, kx);
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float qx[E];
          load_f32<float, E>(qh + g * HDP + c, qx);
#pragma unroll
          for (int e = 0; e < E; ++e) s[g] = fmaf(qx[e], kx[e], s[g]);
        }
      }
      const bool ok = attended(kp[0]);
      float sg[GP], mx[GP], pr[GP], sum[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float full = s[g] + __shfl_xor_sync(kFull, s[g], 16);
        sg[g] = ok ? full : kNegInf;
        mx[g] = sg[g];
      }
#pragma unroll
      for (int off = kChunk / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GP; ++g)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(kFull, mx[g], off));
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        mx[g] = fmaxf(m[g], mx[g]);          // the new running max
        pr[g] = expf(sg[g] - mx[g]);
        sum[g] = pr[g];
      }
#pragma unroll
      for (int off = kChunk / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GP; ++g)
          sum[g] += __shfl_xor_sync(kFull, sum[g], off);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float corr = expf(m[g] - mx[g]);
        l[g] = l[g] * corr + sum[g];
        m[g] = mx[g];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] *= corr;
      }
      if (half == 0) {
#pragma unroll
        for (int g = 0; g < GP; ++g) Pw[slot * GP + g] = pr[g];
      }
      __syncwarp();
      // P @ V: lane owns columns lane * DPL .. + DPL - 1 of every head
#pragma unroll 4
      for (int c = 0; c < kChunk; ++c) {
        float vx[DPL], pc[GP];
        load_f32<TKV, DPL>(Vs + c * KS + lane * DPL, vx);
        load_f32<float, GP>(Pw + c * GP, pc);
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            acc[g][j] = fmaf(pc[g], vx[j], acc[g][j]);
      }
    }
    __syncwarp();                // stage st and Pw are consumed
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) kp[j] = kp[j + 1];
    kp[kStages - 1] = kp_new;
#pragma unroll
    for (int j = 0; j < kStages - 2; ++j) ld[j] = ld[j + 1];
    ld[kStages - 2] = ld_nx;
  }
  cp_async_wait<0>();
  __syncthreads();               // every warp is done with its stages

  // The four warps' (m, l, acc) merge, in warp order, into the block's
  // partial.
  float* Wm = after;                                // (kWarps, kMaxG)
  float* Wl = Wm + kWarps * kMaxG;
  float* Wacc = Wl + kWarps * kMaxG;                // (kWarps, kMaxG, HDP)
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < G) {
      if (lane == 0) {
        Wm[warp * kMaxG + g] = m[g];
        Wl[warp * kMaxG + g] = l[g];
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        Wacc[(warp * kMaxG + g) * HDP + lane * DPL + j] = acc[g][j];
    }
  }
  __syncthreads();
  const int64_t pbase = (static_cast<int64_t>(b) * kv + hk) * n_split;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Wm[w * kMaxG + g]);
    float lsum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(Wm[w * kMaxG + g] - M);
      lsum = fmaf(wt, Wl[w * kMaxG + g], lsum);
      a = fmaf(wt, Wacc[(w * kMaxG + g) * HDP + d], a);
    }
    part_acc[((pbase + split) * G + g) * hd + d] = a;
    if (d == 0) {
      part_ml[((pbase + split) * G + g) * 2] = M;
      part_ml[((pbase + split) * G + g) * 2 + 1] = lsum;
    }
  }

  // The last block of this (b, KV head) to arrive combines the splits.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&counters[b * kv + hk], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* Sm = after;                                // (n_split, kMaxG)
  float* Sl = Sm + kMaxSplit * kMaxG;
  float* Sw = Sl + kMaxSplit * kMaxG;
  for (int e = tid; e < n_split * G; e += kThreads) {
    const int s = e / G, g = e % G;
    Sm[s * kMaxG + g] = __ldcg(&part_ml[((pbase + s) * G + g) * 2]);
    Sl[s * kMaxG + g] = __ldcg(&part_ml[((pbase + s) * G + g) * 2 + 1]);
  }
  __syncthreads();
  __shared__ float den[kMaxG];
  if (tid < G) {
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, Sm[s * kMaxG + tid]);
    float lsum = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float wt = expf(Sm[s * kMaxG + tid] - M);
      Sw[s * kMaxG + tid] = wt;
      lsum = fmaf(wt, Sl[s * kMaxG + tid], lsum);
    }
    den[tid] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  // each thread's entries at once, four splits at a time, so that their
  // loads are in flight together
  const int64_t o0 = (static_cast<int64_t>(b) * nh + hk * G) * hd;
  constexpr int kPer = kMaxG * HDP / kThreads;   // entries a thread, at most
  float a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a[j] = 0.0f;
  const int64_t split_stride = static_cast<int64_t>(G) * hd;
  for (int sb = 0; sb < n_split; sb += 4) {
    float x[kPer][4];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      const float* pa = part_acc + (pbase + sb) * split_stride + e;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        x[j][t] = (e < G * hd && sb + t < n_split)
                      ? __ldcg(pa + t * split_stride) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int g = min((tid + j * kThreads) / hd, kMaxG - 1);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (sb + t < n_split)
          a[j] = fmaf(Sw[(sb + t) * kMaxG + g], x[j][t], a[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads;
    if (e < G * hd) {
      const float x = __fdiv_rn(a[j], den[e / hd]);
      if (q_bf16)
        store(static_cast<__nv_bfloat16*>(o) + o0 + e, x);
      else
        store(static_cast<float*>(o) + o0 + e, x);
    }
  }
  if (tid == 0) counters[b * kv + hk] = 0;
}

// The launch arguments, as the entry point takes them.
struct Args {
  const void *q, *k, *v, *pos, *q_pos;
  void *o, *part, *counters;
  int B, C, nh, kv, hd, window, L;
  float scale;
  bool q_bf16;
  cudaStream_t stream;
};

template <typename TKV, int HDP, int GP>
cudaError_t launch(const Args& a) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<TKV, HDP, GP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<TKV, HDP>(kMaxL)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  // 16-byte copies of K and V rows: hd a multiple of the vector and every
  // row start aligned (the row stride is kv * hd elements)
  constexpr int n = 16 / sizeof(TKV);
  const bool vec = a.hd % n == 0 &&
                   reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.v) % 16 == 0;
  const int n_split = (a.C + a.L - 1) / a.L;
  float* part_acc = static_cast<float*>(a.part);
  float* part_ml = part_acc + static_cast<int64_t>(a.B) * a.kv * n_split *
                                  (a.nh / a.kv) * a.hd;
  const dim3 grid(n_split, a.kv, a.B);
  decode_kernel<TKV, HDP, GP>
      <<<grid, kThreads, smem_bytes<TKV, HDP>(a.L), a.stream>>>(
          a.q, static_cast<const TKV*>(a.k), static_cast<const TKV*>(a.v),
          static_cast<const int*>(a.pos), static_cast<const int*>(a.q_pos),
          a.o, a.q_bf16, part_acc, part_ml, static_cast<int*>(a.counters),
          a.C, a.nh, a.kv, a.hd, a.window, a.scale, a.L, vec);
  return cudaGetLastError();
}

template <typename TKV, int HDP>
cudaError_t by_group(const Args& a) {
  const int G = a.nh / a.kv;
  if (G <= 1) return launch<TKV, HDP, 1>(a);
  if (G <= 2) return launch<TKV, HDP, 2>(a);
  if (G <= 4) return launch<TKV, HDP, 4>(a);
  return launch<TKV, HDP, 8>(a);
}

template <typename TKV>
cudaError_t dispatch(const Args& a) {
  if (a.hd <= 32) return by_group<TKV, 32>(a);
  if (a.hd <= 64) return by_group<TKV, 64>(a);
  return by_group<TKV, 128>(a);
}

}  // namespace

// q_dtype, kv_dtype: 0 = f32, 1 = bf16.  scale: hd^-0.5 as an f32.  L:
// slots a split (a multiple of 64); part: B * kv * ceil(C / L) * (nh / kv)
// * (hd + 2) floats of scratch; counters: B * kv int32, all zero.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, const void* q_pos, void* o,
                                void* part, void* counters, int B, int C,
                                int nh, int kv, int hd, int window,
                                int q_dtype, int kv_dtype, float scale, int L,
                                void* stream) {
  if (B < 1 || C < 1 || kv < 1 || nh % kv || nh / kv > kMaxG || hd < 1 ||
      hd > 128 || kv > 65535 || B > 65535 || L < 64 || L % 64 || L > kMaxL ||
      (C + L - 1) / L > kMaxSplit || (q_dtype != 0 && q_dtype != 1))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, pos, q_pos, o, part, counters, B, C, nh, kv, hd,
               window, L, scale, q_dtype == 1,
               static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 0) return dispatch<float>(a);
  if (kv_dtype == 1) return dispatch<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}
