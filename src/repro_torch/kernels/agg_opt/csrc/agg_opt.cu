// Fused tall aggregation + Nesterov update (PHub §3.2.2) for sm_90a.
//
// Replaces the Pallas kernels in src/repro/kernels/agg_opt/kernel.py:
//   agg_opt_chunks       (kernel.py:38, body _agg_opt_body at :26), W = 1
//   multi_agg_opt_chunks (kernel.py:187), W workers stacked on dim 0
// One __global__ kernel serves both; W is a runtime loop bound.
//
// Per element, in f32, exactly as _agg_opt_body:
//   g  = (g_0 + g_1 + ... + g_{W-1}) / W     summed in worker order, divided
//   m2 = mu * m + g
//   p2 = p - lr * (g + mu * m2)
// then p2 and m2 are stored in the p and m dtype (f32 or bf16, RNE).  Every
// operation is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn), so no FMA contraction happens whatever the flags, and the
// kernel equals the plain PyTorch version (kernels/agg_opt/ref.py) bitwise.
//
// Bound: HBM bytes.  The pass does about W + 7 flops per element against
// (W + 4) * itemsize bytes (read p, m and W gradients; write p and m): 5
// arrays for W = 1, W + 4 arrays in the stacked case.  At 3.35 TB/s that is
// about 7.4 ms for W = 1 and 11.8 ms for W = 4 over the 1.24 G f32
// parameters of llama3.2-1b; the arithmetic is under 0.2 ms at 67 TFLOP/s.
//
// Design: one block per chunk (chunk_elems a multiple of 128), 256 threads,
// vector loads of 4 elements (16-byte float4 for f32, 8 bytes for bf16), each
// element read and written once, nothing staged in shared memory: the TPU
// kernel's VMEM staging of a chunk has no counterpart to win here, since the
// pass reuses nothing.  A later PR may move the streams through TMA bulk copies
// into a shared-memory ring, or use wider (32-byte) vectors and a
// persistent grid, to get closer to the HBM rate.
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

// p, m, p_out, m_out: (n_chunks, chunk_elems); g: (n_workers, n_chunks,
// chunk_elems), worker w at g + w * n_chunks * chunk_elems.
template <typename T>
__global__ void __launch_bounds__(kThreads)
agg_opt_kernel(const T* __restrict__ p, const T* __restrict__ g,
               const T* __restrict__ m, T* __restrict__ p_out,
               T* __restrict__ m_out, int64_t worker_stride, int n_workers,
               int chunk_elems, float lr, float mu) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float divisor = static_cast<float>(n_workers);
  for (int i = threadIdx.x * kVec; i < chunk_elems; i += kThreads * kVec) {
    const int64_t off = base + i;
    float acc[4], gw[4], mv[4], pv[4];
    load4(g + off, acc);
    for (int w = 1; w < n_workers; ++w) {
      load4(g + w * worker_stride + off, gw);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], gw[k]);
    }
    load4(m + off, mv);
    load4(p + off, pv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float gg = __fdiv_rn(acc[k], divisor);
      const float m2 = __fadd_rn(__fmul_rn(mu, mv[k]), gg);
      const float step = __fmul_rn(lr, __fadd_rn(gg, __fmul_rn(mu, m2)));
      pv[k] = __fadd_rn(pv[k], -step);
      mv[k] = m2;
    }
    store4(p_out + off, pv);
    store4(m_out + off, mv);
  }
}

template <typename T>
int launch(const void* p, const void* g, const void* m, void* p_out,
           void* m_out, long long n_chunks, int chunk_elems, int n_workers,
           float lr, float mu, void* stream) {
  const int64_t stride = static_cast<int64_t>(n_chunks) * chunk_elems;
  agg_opt_kernel<T><<<static_cast<unsigned>(n_chunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const T*>(g),
      static_cast<const T*>(m), static_cast<T*>(p_out),
      static_cast<T*>(m_out), stride, n_workers, chunk_elems, lr, mu);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* p, const void* g, const void* m, void* p_out,
             void* m_out, long long n_chunks, int chunk_elems, int n_workers,
             int dtype, float lr, float mu, void* stream) {
  // dtype: 0 = float32, 1 = bfloat16 (the wrapper has checked everything)
  if (dtype == 0)
    return launch<float>(p, g, m, p_out, m_out, n_chunks, chunk_elems,
                         n_workers, lr, mu, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, m, p_out, m_out, n_chunks,
                                 chunk_elems, n_workers, lr, mu, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int agg_opt_chunks(const void* p, const void* g, const void* m,
                              void* p_out, void* m_out, long long n_chunks,
                              int chunk_elems, int dtype, float lr, float mu,
                              void* stream) {
  return dispatch(p, g, m, p_out, m_out, n_chunks, chunk_elems, 1, dtype, lr,
                  mu, stream);
}

extern "C" int multi_agg_opt_chunks(const void* p, const void* g,
                                    const void* m, void* p_out, void* m_out,
                                    long long n_chunks, int chunk_elems,
                                    int n_workers, int dtype, float lr,
                                    float mu, void* stream) {
  return dispatch(p, g, m, p_out, m_out, n_chunks, chunk_elems, n_workers,
                  dtype, lr, mu, stream);
}
