// One-token GQA decode attention over a position-tagged ring KV cache, for
// sm_90a: the serving hot loop.
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
// NEG_INF = -1e30 and the running max starts there (a block of empty
// slots before the first filled one gets p = exp(0) = 1, which the
// correction exp(-1e30 - m) = 0 wipes; -inf would give NaN); the
// normalizer is clamped at 1e-30.  q is cast to f32, then scaled
// (kernel.py:35).
//
// Layout: q and o (B, 1, nh, hd) in f32 or bf16; k and v one layer's cache
// (B, C, kv, hd), read in place in their own dtype (bf16 on the serving
// path, f32 allowed); pos (B, C) and q_pos (B,) int32.  All contiguous.
// hd <= 128 is padded to HDP (32, 64 or 128) in shared memory only, with
// zeros; nh / kv <= 8.
//
// Bound: HBM bytes.  A decode step reads the whole cache of the layer
// (k and v, 2 * B * C * kv * hd elements, and pos) once, and q and o are
// small: for llama3.2-1b at batch 8 and C = 2080 (bf16) 34.1 MB, 10.2 us at
// 3.35 TB/s; the flops (4 hd per slot and query head) are 8x fewer per
// byte than the f32 units could do.
//
// Design (simple and right; split-K over the cache, as flash-decoding
// does, comes later): one block of 128 threads per (KV head, batch row),
// so the G = nh / kv query heads that share a KV head read its cache once,
// as a (G, hd) tile.  The block walks the cache in blocks of 64 slots: it
// stages the slots' positions, K and V (converted to f32; 16-byte loads
// where hd allows) in shared memory, computes the G x 64 masked scores
// (K rows at a stride of HDP + 1 floats: consecutive slots fall on
// distinct banks), runs the online softmax of each head in one warp, and
// adds P @ V into accumulators held in registers (entry e = tid + 128 i of
// the (G, HDP) output tile).  At llama3.2-1b's batch 8 that is 64 blocks
// on 132 SMs: the loads of one block are not overlapped with another's,
// and the card is far from its HBM rate; that is the split-K work.  fmaf
// in the dot products (the build passes -fmad=false), expf, an IEEE
// division at the end.  The sums run in another order than the plain
// version's (einsum over 1024-slot blocks), so the two agree to rounding.
//
// Launches on the caller's stream and allocates nothing.  The entry point
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 64;          // cache slots per block step
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;         // query heads per KV head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The elements of one 16-byte vector, converted to f32.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kMaxG) * HDP +
                          kBS * (HDP + 1) + kBS * HDP + kMaxG * kBS);
}

template <typename TQ, typename TKV, int HDP>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ pos,
              const int* __restrict__ q_pos, TQ* __restrict__ o, int C,
              int nh, int kv, int hd, int window, float scale, bool vec) {
  constexpr int KS = HDP + 1;                     // row stride of K
  constexpr int NACC = kMaxG * HDP / kThreads;    // accumulators a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);    // (kMaxG, HDP)
  float* Ks = Qs + kMaxG * HDP;                   // (kBS, KS)
  float* Vs = Ks + kBS * KS;                      // (kBS, HDP)
  float* S = Vs + kBS * HDP;                      // (kMaxG, kBS)
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ int kp_s[kBS];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = nh / kv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = q_pos[b];
  const TQ* qb = q + (static_cast<int64_t>(b) * nh + hk * G) * hd;
  const int64_t slot_stride = static_cast<int64_t>(kv) * hd;
  const TKV* kb = k + static_cast<int64_t>(b) * C * slot_stride + hk * hd;
  const TKV* vb = v + static_cast<int64_t>(b) * C * slot_stride + hk * hd;
  const int* pb = pos + static_cast<int64_t>(b) * C;

  for (int e = tid; e < kMaxG * HDP; e += kThreads) {
    const int g = e / HDP, d = e % HDP;
    Qs[e] = (g < G && d < hd) ? to_f32(qb[g * hd + d]) * scale : 0.0f;
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kBS) {
    __syncthreads();             // the last block's K, V and S are consumed
    for (int r = tid; r < kBS; r += kThreads)
      kp_s[r] = c0 + r < C ? pb[c0 + r] : -1;
    if (vec) {
      constexpr int n = Vec16<TKV>::n;
      const int per_row = HDP / n;
      for (int e = tid; e < kBS * per_row; e += kThreads) {
        const int r = e / per_row, d = (e % per_row) * n, c = c0 + r;
        float kx[n], vx[n];
        if (c < C && d < hd) {
          Vec16<TKV>::load(kb + c * slot_stride + d, kx);
          Vec16<TKV>::load(vb + c * slot_stride + d, vx);
        } else {
#pragma unroll
          for (int i = 0; i < n; ++i) kx[i] = vx[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < n; ++i) {
          Ks[r * KS + d + i] = kx[i];
          Vs[r * HDP + d + i] = vx[i];
        }
      }
    } else {
      for (int e = tid; e < kBS * HDP; e += kThreads) {
        const int r = e / HDP, d = e % HDP, c = c0 + r;
        float kx = 0.0f, vx = 0.0f;
        if (c < C && d < hd) {
          kx = to_f32(kb[c * slot_stride + d]);
          vx = to_f32(vb[c * slot_stride + d]);
        }
        Ks[r * KS + d] = kx;
        Vs[r * HDP + d] = vx;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * kBS; e += kThreads) {
      const int g = e / kBS, c = e % kBS;
      const float* qr = Qs + g * HDP;
      const float* kr = Ks + c * KS;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HDP; ++d) s = fmaf(qr[d], kr[d], s);
      const int kp = kp_s[c];
      const bool ok = kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
      S[e] = ok ? s : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* row = S + g * kBS;
      const float a = row[lane], c = row[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + kThreads * i, g = e / HDP, d = e % HDP;
      if (g < G) {
        const float* p = S + g * kBS;
        float a = acc[i] * corr_s[g];
#pragma unroll 8
        for (int c = 0; c < kBS; ++c) a = fmaf(p[c], Vs[c * HDP + d], a);
        acc[i] = a;
      }
    }
  }

  TQ* ob = o + (static_cast<int64_t>(b) * nh + hk * G) * hd;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + kThreads * i, g = e / HDP, d = e % HDP;
    if (g < G && d < hd)
      store(&ob[g * hd + d], __fdiv_rn(acc[i], fmaxf(l_s[g], 1e-30f)));
  }
}

template <typename TQ, typename TKV, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, const void* q_pos, void* o, int B, int C,
                   int nh, int kv, int hd, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<TQ, TKV, HDP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  // 16-byte loads of K and V rows: hd a multiple of the vector and every
  // row start aligned (the row stride is kv * hd elements)
  constexpr int n = Vec16<TKV>::n;
  const bool vec = hd % n == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid(kv, B);
  decode_kernel<TQ, TKV, HDP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(pos),
      static_cast<const int*>(q_pos), static_cast<TQ*>(o), C, nh, kv, hd,
      window, scale, vec);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* pos, const void* q_pos, void* o, int B,
                     int C, int nh, int kv, int hd, int window, float scale,
                     cudaStream_t s) {
  if (hd <= 32)
    return launch<TQ, TKV, 32>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                               window, scale, s);
  if (hd <= 64)
    return launch<TQ, TKV, 64>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                               window, scale, s);
  return launch<TQ, TKV, 128>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                              window, scale, s);
}

}  // namespace

// q_dtype, kv_dtype: 0 = f32, 1 = bf16.  scale: hd^-0.5 as an f32.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* pos, const void* q_pos, void* o,
                                int B, int C, int nh, int kv, int hd,
                                int window, int q_dtype, int kv_dtype,
                                float scale, void* stream) {
  if (B < 1 || C < 1 || kv < 1 || nh % kv || nh / kv > kMaxG || hd < 1 ||
      hd > 128 || kv > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch<float, float>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                                  window, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return dispatch<float, bf16>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                                 window, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return dispatch<bf16, float>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                                 window, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<bf16, bf16>(q, k, v, pos, q_pos, o, B, C, nh, kv, hd,
                                window, scale, s);
  return cudaErrorInvalidValue;
}
