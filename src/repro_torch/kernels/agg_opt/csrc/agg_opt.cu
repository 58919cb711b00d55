// Fused tall aggregation + optimizer updates (PHub §3.2.2) for sm_90a.
//
// Replaces the Pallas kernels in src/repro/kernels/agg_opt/kernel.py:
//   agg_opt_chunks       (kernel.py:38, body _agg_opt_body at :26), W = 1
//   multi_agg_opt_chunks (kernel.py:187), W workers stacked on dim 0
//   sgd_opt_chunks       (kernel.py:60, body _sgd_body at :54)
//   adam_opt_chunks      (kernel.py:100, body _adam_body at :75)
//   dequant_agg_opt_chunks (kernel.py:139, body _dequant_agg_opt_body at
//                        :123), the tail of the int8 wire's ring
//   health_chunks        (kernel.py:173, body _health_body at :161), the
//                        sanity gate's sum of squares per chunk
// Each rule is one __global__ kernel; W is a runtime loop bound, so W = 1
// is exactly the TPU kernel and W > 1 folds the stacked workers' sum and
// the /W (on one card, the whole reduce-scatter + mean) into the pass.
// The stacked rules take an optional device pointer to the divisor: null
// divides by W; set, it divides by the f32 it points at, the live count of
// the elastic or sanity-gated step (the reference's psum_scatter(...) / N
// with a traced N), read on the card so the step needs no host sync.
//
// Per element, in f32, with g = (g_0 + g_1 + ... + g_{W-1}) / d summed in
// worker order and then divided (d = W, or *divisor):
//   Nesterov  m2 = mu * m + g;  p2 = p - lr * (g + mu * m2)
//   SGD       p2 = p - lr * g
//   Adam      alive = g != 0 || k1 != 0
//             k1n = alive ? b1 * k1 + c1 : k1    (c1 = 1 - b1, from the host)
//             k2n = alive ? b2 * k2 + c2 : k2    (c2 = 1 - b2, from the host)
//             m2 = b1 * m + c1 * g;  v2 = b2 * v + (c2 * g) * g
//             rk2 = sqrt(k2n)
//             step = ((lr * (1 / k1n)) * rk2 * m2) / (sqrt(v2) + eps * rk2)
//             p2 = p - (k1n > 0 ? step : +0)
// and for dequant_agg_opt_chunks, with the int8 ring partial q, its chunk's
// f32 scale s and the owner's own gradient row g_own,
//   g = (q * s + g_own) * inv_n,  then the Nesterov update;
// then every result is stored in its input's dtype (f32 or bf16, RNE; Adam's
// k1/k2 are always f32).  The gradient g of the three rules has the dtype
// of p, or is f32 in a bf16 group: the decoded int8 wire partial, which the
// int8 wire hands SGD and Adam as a mean in f32 (core/pipeline.py).  Every
// operation is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsqrt_rn), in the order the Python expression evaluates, so
// no FMA contraction happens whatever the flags, and each kernel equals its
// plain PyTorch version
// (kernels/agg_opt/ref.py) bitwise.  The constants, 1 - b included, are
// rounded to f32 on the host: 1.0f - 0.9f is 3 ulp from (float)(1 - 0.9).
//
// Bound: HBM bytes.  Per element the passes read W gradients and the state
// and write the state: Nesterov W + 4 arrays, SGD W + 2, Adam W + 10 (p, m,
// v, k1, k2 read; p, m, v, k1, k2 written).  Over the 1.24 G f32 parameters
// of llama3.2-1b at 3.35 TB/s that is 7.4 / 11.8 ms (Nesterov W = 1 / 4),
// 4.4 / 8.9 ms (SGD) and 16.2 / 20.7 ms (Adam).  dequant_agg_opt_chunks
// reads p, m, g_own (4 bytes each), q (1) and writes p, m: 21 bytes an
// element, 7.75 ms over the W = 4 domain.  Adam's arithmetic, two IEEE
// divisions and two square roots an element, stays under 1 ms at 67 TFLOP/s.
// health_chunks reads its input once and writes one f32 a chunk: 19.77 GB,
// 5.90 ms over the stacked W = 4 f32 domain, 4.94 GB, 1.48 ms at W = 1.
//
// Design: one block per chunk (chunk_elems a multiple of 128; for the
// dequant kernel the wire's chunk, a multiple of 4, since the scale is
// per chunk), 256 threads,
// vector loads of 4 elements (16-byte float4 for f32, 8 bytes for bf16), each
// element read and written once, nothing staged in shared memory (the
// dequant kernel reads its chunk's one scale and 4 int8 a thread): the TPU
// kernel's VMEM staging of a chunk has no counterpart to win here, since the
// pass reuses nothing.  Adam's slots m, v, k1, k2 are updated in place (one
// in-out pointer each; every thread reads and writes only its own
// elements), which keeps four model-sized vectors off the card at W = 4; p
// is written to a new buffer.  A later PR may move the streams through TMA
// bulk copies into a shared-memory ring, or use wider (32-byte) vectors and
// a persistent grid, to get closer to the HBM rate.
//
// health_chunks has a fixed summation order, so it is the same run to run
// and its plain version (ref.py::health_chunks_ref) repeats it bitwise: one
// block of 256 threads per chunk, no atomics.  Thread t reads the 4-element
// vectors at t*4 + k*1024, k = 0, 1, ..., and adds each square (components in
// order) to its own running f32 sum, every product and sum rounded on its
// own; then a warp tree (__shfl_down_sync by 16, 8, 4, 2, 1: lane l takes
// its sum plus lane l + offset's), then warp 0 reduces the 8 warp sums from
// shared memory the same way (by 4, 2, 1).  NaN and Inf propagate: nothing
// is clamped or skipped, and a square that overflows is +Inf.
//
// Launches on the caller's stream and allocates nothing.  Each entry point
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

__device__ __forceinline__ void load4(const float* ptr, float v[4]) {
  float4 t = *reinterpret_cast<const float4*>(ptr);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* ptr, float v[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(ptr);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* ptr, const float v[4]) {
  *reinterpret_cast<float4*>(ptr) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* ptr, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(ptr) = t;
}

// The mean's divisor: W, or the live count the caller keeps on the card.
__device__ __forceinline__ float mean_divisor(const float* divisor,
                                              int n_workers) {
  return divisor != nullptr ? *divisor : static_cast<float>(n_workers);
}

// g = (g_0 + ... + g_{W-1}) / d for the 4 elements at off, in worker order.
template <typename G>
__device__ __forceinline__ void worker_mean4(const G* __restrict__ g,
                                             int64_t off,
                                             int64_t worker_stride,
                                             int n_workers, float d,
                                             float acc[4]) {
  float gw[4];
  load4(g + off, acc);
  for (int w = 1; w < n_workers; ++w) {
    load4(g + w * worker_stride + off, gw);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], gw[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = __fdiv_rn(acc[k], d);
}

// m2 = mu * m + g; p2 = p - lr * (g + mu * m2), for 4 elements in place.
__device__ __forceinline__ void nesterov4(float pv[4], float mv[4],
                                          const float gg[4], float lr,
                                          float mu) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float m2 = __fadd_rn(__fmul_rn(mu, mv[k]), gg[k]);
    const float step = __fmul_rn(lr, __fadd_rn(gg[k], __fmul_rn(mu, m2)));
    pv[k] = __fadd_rn(pv[k], -step);
    mv[k] = m2;
  }
}

// p, m, p_out, m_out: (n_chunks, chunk_elems); g: (n_workers, n_chunks,
// chunk_elems), worker w at g + w * n_chunks * chunk_elems.
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
agg_opt_kernel(const T* __restrict__ p, const G* __restrict__ g,
               const T* __restrict__ m, T* __restrict__ p_out,
               T* __restrict__ m_out, int64_t worker_stride, int n_workers,
               const float* __restrict__ divisor, int chunk_elems, float lr,
               float mu) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float d = mean_divisor(divisor, n_workers);
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    const int64_t off = base + i;
    float gg[4], mv[4], pv[4];
    worker_mean4(g, off, worker_stride, n_workers, d, gg);
    load4(m + off, mv);
    load4(p + off, pv);
    nesterov4(pv, mv, gg, lr, mu);
    store4(p_out + off, pv);
    store4(m_out + off, mv);
  }
}

// p, p_out: (n_chunks, chunk_elems); g as for agg_opt_kernel.
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
sgd_opt_kernel(const T* __restrict__ p, const G* __restrict__ g,
               T* __restrict__ p_out, int64_t worker_stride, int n_workers,
               const float* __restrict__ divisor, int chunk_elems, float lr) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float d = mean_divisor(divisor, n_workers);
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    const int64_t off = base + i;
    float gg[4], pv[4];
    worker_mean4(g, off, worker_stride, n_workers, d, gg);
    load4(p + off, pv);
#pragma unroll
    for (int k = 0; k < 4; ++k) pv[k] = __fsub_rn(pv[k], __fmul_rn(lr, gg[k]));
    store4(p_out + off, pv);
  }
}

// p, p_out, m, v: (n_chunks, chunk_elems) of T; k1, k2 the same shape in
// f32; m, v, k1, k2 are read and overwritten in place.
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
adam_opt_kernel(const T* __restrict__ p, const G* __restrict__ g,
                T* __restrict__ m, T* __restrict__ v, float* __restrict__ k1,
                float* __restrict__ k2, T* __restrict__ p_out,
                int64_t worker_stride, int n_workers,
                const float* __restrict__ divisor, int chunk_elems, float lr,
                float b1, float c1, float b2, float c2, float eps) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float d = mean_divisor(divisor, n_workers);
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    const int64_t off = base + i;
    float gg[4], pv[4], mv[4], vv[4], k1v[4], k2v[4];
    worker_mean4(g, off, worker_stride, n_workers, d, gg);
    load4(m + off, mv);
    load4(v + off, vv);
    load4(k1 + off, k1v);
    load4(k2 + off, k2v);
    load4(p + off, pv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool alive = (gg[k] != 0.0f) || (k1v[k] != 0.0f);
      const float k1n = alive ? __fadd_rn(__fmul_rn(b1, k1v[k]), c1) : k1v[k];
      const float k2n = alive ? __fadd_rn(__fmul_rn(b2, k2v[k]), c2) : k2v[k];
      const float m2 = __fadd_rn(__fmul_rn(b1, mv[k]), __fmul_rn(c1, gg[k]));
      const float v2 = __fadd_rn(__fmul_rn(b2, vv[k]),
                                 __fmul_rn(__fmul_rn(c2, gg[k]), gg[k]));
      const float rk2 = __fsqrt_rn(k2n);
      const float num = __fmul_rn(
          __fmul_rn(__fmul_rn(lr, __fdiv_rn(1.0f, k1n)), rk2), m2);
      const float den = __fadd_rn(__fsqrt_rn(v2), __fmul_rn(eps, rk2));
      const float step = k1n > 0.0f ? __fdiv_rn(num, den) : 0.0f;
      pv[k] = __fsub_rn(pv[k], step);
      mv[k] = m2;
      vv[k] = v2;
      k1v[k] = k1n;
      k2v[k] = k2n;
    }
    store4(p_out + off, pv);
    store4(m + off, mv);
    store4(v + off, vv);
    store4(k1 + off, k1v);
    store4(k2 + off, k2v);
  }
}

// p, m, g_own, p_out, m_out: (n_chunks, chunk_elems) of T, except that
// g_own's chunk c starts at c * chunk_elems + (c * chunk_elems / shard_len)
// * own_stride: own_stride = 0 reads a contiguous g_own, and own_stride =
// S * shard_len reads the block diagonal of the stacked (S, S * shard_len)
// gradient buffer in place (shard j's own row j).  q: (n_chunks,
// chunk_elems) int8; scales: (n_chunks,) f32.  chunk_elems is the wire's
// chunk (one scale each), a multiple of 4; shard_len a multiple of it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_agg_opt_kernel(const T* __restrict__ p, const int8_t* __restrict__ q,
                       const float* __restrict__ scales,
                       const T* __restrict__ g_own, const T* __restrict__ m,
                       T* __restrict__ p_out, T* __restrict__ m_out,
                       int64_t shard_len, int64_t own_stride,
                       int chunk_elems, float lr, float mu, float inv_n) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const T* own = g_own + base + (base / shard_len) * own_stride;
  const float s = scales[blockIdx.x];
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    const int64_t off = base + i;
    const char4 c = *reinterpret_cast<const char4*>(q + off);
    const float qv[4] = {static_cast<float>(c.x), static_cast<float>(c.y),
                         static_cast<float>(c.z), static_cast<float>(c.w)};
    float gg[4], mv[4], pv[4];
    load4(own + i, gg);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      gg[k] = __fmul_rn(__fadd_rn(__fmul_rn(qv[k], s), gg[k]), inv_n);
    load4(m + off, mv);
    load4(p + off, pv);
    nesterov4(pv, mv, gg, lr, mu);
    store4(p_out + off, pv);
    store4(m_out + off, mv);
  }
}

// g: (n_chunks, chunk_elems) in G; out: (n_chunks,) f32 sums of squares.
// chunk_elems a multiple of 4.  The summation order is in the header.
template <typename G>
__global__ void __launch_bounds__(kThreads)
health_kernel(const G* __restrict__ g, float* __restrict__ out,
              int chunk_elems) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  float acc = 0.0f;
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    float v[4];
    load4(g + base + i, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  }
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    if (lane == 0) out[blockIdx.x] = s;
  }
}

template <typename X>
struct Tag {
  using type = X;
};

// Calls f(Tag<T>{}, Tag<G>{}) for the state dtype T and gradient dtype G
// that code names: 0 = float32, 1 = bfloat16, 2 = bfloat16 with a float32
// gradient (the wrapper has checked everything else).
template <typename F>
int with_dtypes(int dtype, F f) {
  if (dtype == 0) return f(Tag<float>{}, Tag<float>{});
  if (dtype == 1) return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
  if (dtype == 2) return f(Tag<__nv_bfloat16>{}, Tag<float>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const void* p, const void* g, const void* m, void* p_out,
             void* m_out, long long n_chunks, int chunk_elems, int n_workers,
             int dtype, float lr, float mu, const void* divisor,
             void* stream) {
  return with_dtypes(dtype, [&](auto tt, auto tg) {
    using T = typename decltype(tt)::type;
    using G = typename decltype(tg)::type;
    const int64_t stride = static_cast<int64_t>(n_chunks) * chunk_elems;
    agg_opt_kernel<T, G><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const G*>(g),
        static_cast<const T*>(m), static_cast<T*>(p_out),
        static_cast<T*>(m_out), stride, n_workers,
        static_cast<const float*>(divisor), chunk_elems, lr, mu);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int agg_opt_chunks(const void* p, const void* g, const void* m,
                              void* p_out, void* m_out, long long n_chunks,
                              int chunk_elems, int dtype, float lr, float mu,
                              void* stream) {
  return dispatch(p, g, m, p_out, m_out, n_chunks, chunk_elems, 1, dtype, lr,
                  mu, nullptr, stream);
}

// divisor: null (divide by n_workers) or a device pointer to one f32, here
// and in sgd_opt_chunks and adam_opt_chunks.
extern "C" int multi_agg_opt_chunks(const void* p, const void* g,
                                    const void* m, void* p_out, void* m_out,
                                    long long n_chunks, int chunk_elems,
                                    int n_workers, int dtype, float lr,
                                    float mu, const void* divisor,
                                    void* stream) {
  return dispatch(p, g, m, p_out, m_out, n_chunks, chunk_elems, n_workers,
                  dtype, lr, mu, divisor, stream);
}

// dtype: 0 = float32, 1 = bfloat16 for p, g (and Adam's m, v), 2 = a
// bfloat16 p (m, v) with a float32 g; Adam's k1 and k2 are float32 always.
// The wrapper has checked everything else.
extern "C" int sgd_opt_chunks(const void* p, const void* g, void* p_out,
                              long long n_chunks, int chunk_elems,
                              int n_workers, int dtype, float lr,
                              const void* divisor, void* stream) {
  return with_dtypes(dtype, [&](auto tt, auto tg) {
    using T = typename decltype(tt)::type;
    using G = typename decltype(tg)::type;
    const int64_t stride = static_cast<int64_t>(n_chunks) * chunk_elems;
    sgd_opt_kernel<T, G><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const G*>(g),
        static_cast<T*>(p_out), stride, n_workers,
        static_cast<const float*>(divisor), chunk_elems, lr);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int adam_opt_chunks(const void* p, const void* g, void* m, void* v,
                               void* k1, void* k2, void* p_out,
                               long long n_chunks, int chunk_elems,
                               int n_workers, int dtype, float lr, float b1,
                               float c1, float b2, float c2, float eps,
                               const void* divisor, void* stream) {
  return with_dtypes(dtype, [&](auto tt, auto tg) {
    using T = typename decltype(tt)::type;
    using G = typename decltype(tg)::type;
    const int64_t stride = static_cast<int64_t>(n_chunks) * chunk_elems;
    adam_opt_kernel<T, G><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const G*>(g),
        static_cast<T*>(m), static_cast<T*>(v), static_cast<float*>(k1),
        static_cast<float*>(k2), static_cast<T*>(p_out), stride, n_workers,
        static_cast<const float*>(divisor), chunk_elems, lr, b1, c1, b2, c2,
        eps);
    return static_cast<int>(cudaGetLastError());
  });
}

// dtype: 0 = float32, 1 = bfloat16 for p, g_own and m.  own_stride and
// shard_len as for dequant_agg_opt_kernel.
extern "C" int dequant_agg_opt_chunks(const void* p, const void* q,
                                      const void* scales, const void* g_own,
                                      const void* m, void* p_out,
                                      void* m_out, long long n_chunks,
                                      int chunk_elems, long long shard_len,
                                      long long own_stride, int dtype,
                                      float lr, float mu, float inv_n,
                                      void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_dtypes(dtype, [&](auto tt, auto) {
    using T = typename decltype(tt)::type;
    dequant_agg_opt_kernel<T><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const int8_t*>(q),
        static_cast<const float*>(scales), static_cast<const T*>(g_own),
        static_cast<const T*>(m), static_cast<T*>(p_out),
        static_cast<T*>(m_out), shard_len, own_stride, chunk_elems, lr, mu,
        inv_n);
    return static_cast<int>(cudaGetLastError());
  });
}

// dtype: 0 = float32, 1 = bfloat16 for g; out is float32.
extern "C" int health_chunks(const void* g, void* out, long long n_chunks,
                             int chunk_elems, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_dtypes(dtype, [&](auto, auto tg) {
    using G = typename decltype(tg)::type;
    health_kernel<G><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const G*>(g), static_cast<float*>(out), chunk_elems);
    return static_cast<int>(cudaGetLastError());
  });
}
