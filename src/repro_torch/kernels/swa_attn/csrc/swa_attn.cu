// Flash causal sliding-window GQA attention, forward only, for sm_90a.
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
// lanes add exact zeros to every dot product and are never stored.
//
// Bound: operations.  Per allowed (query, key) pair and head the kernel
// does 2 hd flops for q.k and 2 hd for p.v; on the prefill path (f32, as
// the reference computes bf16 x f32 projections in f32) that is work for
// the SIMT f32 units (67 TFLOP/s), and q, k, v and o cross HBM once.
//
// Design (a simple kernel that is right; wgmma and TMA come later): one
// block of 256 threads per (q tile of 64 rows, query head, batch row),
// heaviest tiles (the last rows, most keys) scheduled first.  The key loop
// runs only over the tiles that intersect [max(0, first_q - w + 1),
// last_q]: masked tiles are never visited (the TPU grid steps through
// them).  Q (pre-scaled), K and V tiles are staged in shared memory as f32
// (the K/V tiles of one KV head are read by its G query heads' blocks, from
// L2; KV is never replicated in HBM).  Thread (ty, tx) of a 16 x 16 grid
// holds the scores of rows 4ty..4ty+3 and columns tx + 16j: Q and K rows
// have a stride of HDP + 4 floats, so the float4 loads of a quarter warp
// fall on distinct banks.  Row max and sum reduce over the 16 lanes of a
// half warp; P goes through shared memory transposed, so P @ V reads a
// row quad as one float4.  f32 arithmetic on the SIMT units: fmaf in the
// dot products (the build passes -fmad=false), expf, an IEEE division at
// the end.  The sums run in another order than the plain version's
// (einsum over 1024-key blocks), so the two agree to rounding, not bitwise.
//
// Launches on the caller's stream and allocates nothing.  The entry point
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = kBQ + 4;     // row stride of the transposed P tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (HDP + 4) + kBK * (HDP + 4) +
          kBK * HDP + kBK * kPS);
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
swa_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int seq, int nh,
           int kv, int hd, int window, float scale) {
  constexpr int QS = HDP + 4;    // row stride of the Q and K tiles
  constexpr int DJ = HDP / 16;   // output columns a thread holds
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Pt = Vs + kBK * HDP;

  const int tile = gridDim.x - 1 - blockIdx.x;       // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (nh / kv);
  const int q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t q_stride = static_cast<int64_t>(nh) * hd;   // one t of q, o
  const int64_t k_stride = static_cast<int64_t>(kv) * hd;   // one t of k, v
  const T* qb = q + static_cast<int64_t>(b) * seq * q_stride + h * hd;
  const T* kb = k + static_cast<int64_t>(b) * seq * k_stride + hk * hd;
  const T* vb = v + static_cast<int64_t>(b) * seq * k_stride + hk * hd;

  for (int e = tid; e < kBQ * HDP; e += kThreads) {
    const int r = e / HDP, d = e % HDP, t = q0 + r;
    Qs[r * QS + d] = (t < seq && d < hd)
                         ? to_f32(qb[t * q_stride + d]) * scale : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int last_q = min(q0 + kBQ, seq) - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = kv_lo / kBK; kt <= last_q / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();             // the last tile's K, V and P are consumed
    for (int e = tid; e < kBK * HDP; e += kThreads) {
      const int r = e / HDP, d = e % HDP, t = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (t < seq && d < hd) {
        kx = to_f32(kb[t * k_stride + d]);
        vx = to_f32(vb[t * k_stride + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * HDP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online softmax of each of the thread's four rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok =
            kp < seq && kp <= qp && (window <= 0 || kp > qp - window);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * kPS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * kPS + ty * 4]);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * HDP + tx + 16 * j];
        acc[0][j] = fmaf(p.x, vv, acc[0][j]);
        acc[1][j] = fmaf(p.y, vv, acc[1][j]);
        acc[2][j] = fmaf(p.z, vv, acc[2][j]);
        acc[3][j] = fmaf(p.w, vv, acc[3][j]);
      }
    }
  }

  T* ob = o + static_cast<int64_t>(b) * seq * q_stride + h * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= seq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) store(&ob[t * q_stride + d], __fdiv_rn(acc[i][j], den));
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int T_, int nh, int kv, int hd, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HDP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((T_ + kBQ - 1) / kBQ, nh, B);
  swa_kernel<T, HDP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_, nh, kv, hd, window,
      scale);
  return cudaGetLastError();
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
