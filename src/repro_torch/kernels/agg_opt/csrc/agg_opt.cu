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
//   g = (q * s + g_own) * inv_n   (or / d, d = *divisor),
// then the Nesterov update.  Under weight decay (wd != 0, Nesterov, Adam and
// the int8 tail; the reference's ShardedOptimizer._decayed) the rule takes
//   g = g + wd * p     (p in f32; the product, then the sum, each rounded)
// in place of g, after the mean (or the decode, the owner's add and the
// scale) and before the rule, Adam's alive test included.  At wd == 0 the
// term is skipped, not added as 0 * p (0 * inf is NaN), so the kernels keep
// the bits they had without it.  p is read already, so decay adds no bytes.
// Then every result is stored in its input's dtype (f32 or bf16, RNE; Adam's
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
// The four update kernels take n, the elements of a row, and run
// ceil(n / chunk_elems) blocks: the last chunk may be ragged, and its
// elements past n are neither read nor written (a partial 4-vector goes
// element by element), so no input is padded.  The stacked gradient's
// rows lie g_row_stride elements apart: the whole (W, n) buffer
// (stride n), or a window of it read in place, the strip [a, a + n) of
// each row of the (W, padded) buffer (stride padded), as the windowed and
// chunk-ready exchanges hand it (core/pipeline.py); every row must start
// 16 bytes aligned.  Nesterov's m_out may be m itself (the windowed
// exchange updates m in place, as Adam updates its slots): each thread
// reads an element before it writes the same one.
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float* ptr, float x) { *ptr = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* ptr, float x) {
  *ptr = __float2bfloat16_rn(x);
}

// The 4 elements at ptr, or the first cnt of them (the ragged end of a
// row; the others read as 0 and are never stored).
template <typename X>
__device__ __forceinline__ void load4(const X* ptr, float v[4], int cnt) {
  if (cnt >= kVec) {
    load4(ptr, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = k < cnt ? to_float(ptr[k]) : 0.0f;
}

template <typename X>
__device__ __forceinline__ void store4(X* ptr, const float v[4], int cnt) {
  if (cnt >= kVec) {
    store4(ptr, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (k < cnt) from_float(ptr + k, v[k]);
}

// Elements of this block's chunk that lie in the row (n of them): the whole
// chunk but for the last block of a ragged row.
__device__ __forceinline__ int chunk_valid(int64_t base, int64_t n,
                                           int chunk_elems) {
  const int64_t rest = n - base;
  return rest < chunk_elems ? static_cast<int>(rest) : chunk_elems;
}

// The mean's divisor: W, or the live count the caller keeps on the card.
__device__ __forceinline__ float mean_divisor(const float* divisor,
                                              int n_workers) {
  return divisor != nullptr ? *divisor : static_cast<float>(n_workers);
}

// g = (g_0 + ... + g_{W-1}) / d for the 4 elements at off (the first cnt
// of them), in worker order; worker w's row starts at g + w * row_stride.
template <typename G>
__device__ __forceinline__ void worker_mean4(const G* __restrict__ g,
                                             int64_t off,
                                             int64_t row_stride,
                                             int n_workers, float d,
                                             float acc[4], int cnt) {
  float gw[4];
  load4(g + off, acc, cnt);
  for (int w = 1; w < n_workers; ++w) {
    load4(g + w * row_stride + off, gw, cnt);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], gw[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = __fdiv_rn(acc[k], d);
}

// g = g + wd * p for 4 elements, or g as it is at wd == 0.
__device__ __forceinline__ void decay4(float gg[4], const float pv[4],
                                       float wd) {
  if (wd == 0.0f) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) gg[k] = __fadd_rn(gg[k], __fmul_rn(wd, pv[k]));
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

// p, m, p_out, m_out: (n,) in chunks of chunk_elems; g: n_workers rows of
// n, row w at g + w * row_stride.  m_out may be m (not __restrict__).
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
agg_opt_kernel(const T* __restrict__ p, const G* __restrict__ g,
               const T* m, T* __restrict__ p_out, T* m_out, int64_t n,
               int64_t row_stride, int n_workers,
               const float* __restrict__ divisor, int chunk_elems, float lr,
               float mu, float wd) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const int valid = chunk_valid(base, n, chunk_elems);
  const float d = mean_divisor(divisor, n_workers);
  for (int i = threadIdx.x * kVec; i < valid; i += kThreads * kVec) {
    const int64_t off = base + i;
    const int cnt = valid - i;
    float gg[4], mv[4], pv[4];
    worker_mean4(g, off, row_stride, n_workers, d, gg, cnt);
    load4(m + off, mv, cnt);
    load4(p + off, pv, cnt);
    decay4(gg, pv, wd);
    nesterov4(pv, mv, gg, lr, mu);
    store4(p_out + off, pv, cnt);
    store4(m_out + off, mv, cnt);
  }
}

// p, p_out: (n,) in chunks of chunk_elems; g as for agg_opt_kernel.
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
sgd_opt_kernel(const T* __restrict__ p, const G* __restrict__ g,
               T* __restrict__ p_out, int64_t n, int64_t row_stride,
               int n_workers, const float* __restrict__ divisor,
               int chunk_elems, float lr) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const int valid = chunk_valid(base, n, chunk_elems);
  const float d = mean_divisor(divisor, n_workers);
  for (int i = threadIdx.x * kVec; i < valid; i += kThreads * kVec) {
    const int64_t off = base + i;
    const int cnt = valid - i;
    float gg[4], pv[4];
    worker_mean4(g, off, row_stride, n_workers, d, gg, cnt);
    load4(p + off, pv, cnt);
#pragma unroll
    for (int k = 0; k < 4; ++k) pv[k] = __fsub_rn(pv[k], __fmul_rn(lr, gg[k]));
    store4(p_out + off, pv, cnt);
  }
}

// p, p_out, m, v: (n,) of T in chunks of chunk_elems; k1, k2 the same in
// f32; m, v, k1, k2 are read and overwritten in place; g as for
// agg_opt_kernel.
template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
adam_opt_kernel(const T* __restrict__ p, const G* __restrict__ g,
                T* __restrict__ m, T* __restrict__ v, float* __restrict__ k1,
                float* __restrict__ k2, T* __restrict__ p_out, int64_t n,
                int64_t row_stride, int n_workers,
                const float* __restrict__ divisor, int chunk_elems, float lr,
                float b1, float c1, float b2, float c2, float eps,
                float wd) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const int valid = chunk_valid(base, n, chunk_elems);
  const float d = mean_divisor(divisor, n_workers);
  for (int i = threadIdx.x * kVec; i < valid; i += kThreads * kVec) {
    const int64_t off = base + i;
    const int cnt = valid - i;
    float gg[4], pv[4], mv[4], vv[4], k1v[4], k2v[4];
    worker_mean4(g, off, row_stride, n_workers, d, gg, cnt);
    load4(m + off, mv, cnt);
    load4(v + off, vv, cnt);
    load4(k1 + off, k1v, cnt);
    load4(k2 + off, k2v, cnt);
    load4(p + off, pv, cnt);
    decay4(gg, pv, wd);
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
    store4(p_out + off, pv, cnt);
    store4(m + off, mv, cnt);
    store4(v + off, vv, cnt);
    store4(k1 + off, k1v, cnt);
    store4(k2 + off, k2v, cnt);
  }
}

// The launch covers n_rows runs of row_len elements each (row_len a whole
// number of the wire's chunks, chunk_elems a multiple of 4): run j of p, m,
// p_out and m_out starts at j * pm_stride, run j of g_own at j * own_stride,
// and q and scales hold the runs packed one after another (the ring's
// payload of the launch).  So one launch takes a window's strip of every
// shard in place: p's runs lie shard_len apart, and g_own's runs are the
// block diagonal of the stacked (S, padded) gradient buffer (shard j's strip
// of row j, padded + shard_len apart).  The whole domain is the one-window
// case (row_len = pm_stride = shard_len).  divisor: null takes the mean as
// * inv_n (the static form: the full rack or a fixed k-of-n membership,
// 1/N baked on the host, as the reference bakes it into its kernel); set,
// as / *divisor (the sanity gate's live count on the card).  m_out may be m
// (not __restrict__): the windowed exchange updates m in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_agg_opt_kernel(const T* __restrict__ p, const int8_t* __restrict__ q,
                       const float* __restrict__ scales,
                       const T* __restrict__ g_own, const T* m,
                       T* __restrict__ p_out, T* m_out, int64_t row_len,
                       int64_t pm_stride, int64_t own_stride,
                       int chunk_elems, float lr, float mu, float inv_n,
                       const float* __restrict__ divisor, float wd) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const int64_t row = base / row_len;
  const int64_t col = base - row * row_len;
  const int64_t at = row * pm_stride + col;
  const T* own = g_own + row * own_stride + col;
  const float s = scales[blockIdx.x];
  const bool divide = divisor != nullptr;
  const float d = divide ? *divisor : 0.0f;
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    const char4 c = *reinterpret_cast<const char4*>(q + base + i);
    const float qv[4] = {static_cast<float>(c.x), static_cast<float>(c.y),
                         static_cast<float>(c.z), static_cast<float>(c.w)};
    float gg[4], mv[4], pv[4];
    load4(own + i, gg);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float sum = __fadd_rn(__fmul_rn(qv[k], s), gg[k]);
      gg[k] = divide ? __fdiv_rn(sum, d) : __fmul_rn(sum, inv_n);
    }
    load4(m + at + i, mv);
    load4(p + at + i, pv);
    decay4(gg, pv, wd);
    nesterov4(pv, mv, gg, lr, mu);
    store4(p_out + at + i, pv);
    store4(m_out + at + i, mv);
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

// Blocks for n elements in chunks of chunk_elems (the last may be ragged).
unsigned n_blocks(long long n, int chunk_elems) {
  return static_cast<unsigned>((n + chunk_elems - 1) / chunk_elems);
}

int dispatch(const void* p, const void* g, const void* m, void* p_out,
             void* m_out, long long n, int chunk_elems, int n_workers,
             long long g_row_stride, int dtype, float lr, float mu,
             float wd, const void* divisor, void* stream) {
  return with_dtypes(dtype, [&](auto tt, auto tg) {
    using T = typename decltype(tt)::type;
    using G = typename decltype(tg)::type;
    agg_opt_kernel<T, G><<<n_blocks(n, chunk_elems), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const G*>(g),
        static_cast<const T*>(m), static_cast<T*>(p_out),
        static_cast<T*>(m_out), n, g_row_stride, n_workers,
        static_cast<const float*>(divisor), chunk_elems, lr, mu, wd);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// n: elements of p (and of each row of g); the wrapper has checked the
// rest.  m_out may be m.  wd: the weight decay, 0 for none (here and in
// multi_agg_opt_chunks, adam_opt_chunks and dequant_agg_opt_chunks).
extern "C" int agg_opt_chunks(const void* p, const void* g, const void* m,
                              void* p_out, void* m_out, long long n,
                              int chunk_elems, int dtype, float lr, float mu,
                              float wd, void* stream) {
  return dispatch(p, g, m, p_out, m_out, n, chunk_elems, 1, n, dtype, lr, mu,
                  wd, nullptr, stream);
}

// g_row_stride: elements from one worker's row of g to the next, here and
// in sgd_opt_chunks and adam_opt_chunks.  divisor: null (divide by
// n_workers) or a device pointer to one f32.
extern "C" int multi_agg_opt_chunks(const void* p, const void* g,
                                    const void* m, void* p_out, void* m_out,
                                    long long n, int chunk_elems,
                                    int n_workers, long long g_row_stride,
                                    int dtype, float lr, float mu, float wd,
                                    const void* divisor, void* stream) {
  return dispatch(p, g, m, p_out, m_out, n, chunk_elems, n_workers,
                  g_row_stride, dtype, lr, mu, wd, divisor, stream);
}

// dtype: 0 = float32, 1 = bfloat16 for p, g (and Adam's m, v), 2 = a
// bfloat16 p (m, v) with a float32 g; Adam's k1 and k2 are float32 always.
// The wrapper has checked everything else.
extern "C" int sgd_opt_chunks(const void* p, const void* g, void* p_out,
                              long long n, int chunk_elems, int n_workers,
                              long long g_row_stride, int dtype, float lr,
                              const void* divisor, void* stream) {
  return with_dtypes(dtype, [&](auto tt, auto tg) {
    using T = typename decltype(tt)::type;
    using G = typename decltype(tg)::type;
    sgd_opt_kernel<T, G><<<n_blocks(n, chunk_elems), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const G*>(g),
        static_cast<T*>(p_out), n, g_row_stride, n_workers,
        static_cast<const float*>(divisor), chunk_elems, lr);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int adam_opt_chunks(const void* p, const void* g, void* m, void* v,
                               void* k1, void* k2, void* p_out, long long n,
                               int chunk_elems, int n_workers,
                               long long g_row_stride, int dtype, float lr,
                               float b1, float c1, float b2, float c2,
                               float eps, float wd, const void* divisor,
                               void* stream) {
  return with_dtypes(dtype, [&](auto tt, auto tg) {
    using T = typename decltype(tt)::type;
    using G = typename decltype(tg)::type;
    adam_opt_kernel<T, G><<<n_blocks(n, chunk_elems), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const G*>(g),
        static_cast<T*>(m), static_cast<T*>(v), static_cast<float*>(k1),
        static_cast<float*>(k2), static_cast<T*>(p_out), n, g_row_stride,
        n_workers, static_cast<const float*>(divisor), chunk_elems, lr, b1,
        c1, b2, c2, eps, wd);
    return static_cast<int>(cudaGetLastError());
  });
}

// dtype: 0 = float32, 1 = bfloat16 for p, g_own and m.  row_len,
// pm_stride, own_stride and divisor as for dequant_agg_opt_kernel; n_chunks
// = n_rows * row_len / chunk_elems.
extern "C" int dequant_agg_opt_chunks(const void* p, const void* q,
                                      const void* scales, const void* g_own,
                                      const void* m, void* p_out,
                                      void* m_out, long long n_chunks,
                                      int chunk_elems, long long row_len,
                                      long long pm_stride,
                                      long long own_stride, int dtype,
                                      float lr, float mu, float inv_n,
                                      float wd, const void* divisor,
                                      void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return with_dtypes(dtype, [&](auto tt, auto) {
    using T = typename decltype(tt)::type;
    dequant_agg_opt_kernel<T><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(p), static_cast<const int8_t*>(q),
        static_cast<const float*>(scales), static_cast<const T*>(g_own),
        static_cast<const T*>(m), static_cast<T*>(p_out),
        static_cast<T*>(m_out), row_len, pm_stride, own_stride, chunk_elems,
        lr, mu, inv_n, static_cast<const float*>(divisor), wd);
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
