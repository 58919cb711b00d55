// Blockwise int8 wire codec (DESIGN.md §11) for sm_90a.
//
// Replaces the Pallas kernels in src/repro/kernels/quant/kernel.py:
//   quantize_chunks   (kernel.py:34, body _quant_body at :24)
//   dequantize_chunks (kernel.py:55, body _dequant_body at :50)
// Per chunk of chunk_elems f32 values x:
//   amax  = max |x|
//   scale = amax > 0 ? amax / 127 : 1
//   q     = clip(rint(x / scale), -127, 127)      (int8, round half to even)
// and decoding is x' = q * scale.  The division and the product are the
// explicitly rounded intrinsics (__fdiv_rn, __fmul_rn), so each kernel
// equals its plain PyTorch version (kernels/quant/ref.py) bitwise.  The
// scale is amax / 127, divided: XLA:CPU compiles the Pallas body's
// `amax / 127` as `amax * (1/127)`, which differs by an ulp on some chunks,
// so the port holds itself to the eager jnp oracle (quant/ref.py), not to
// the interpret-mode kernel.
//
// Inputs are finite.  fmaxf drops a NaN where the plain version's amax
// propagates it, so on a chunk that holds a NaN the two disagree.
//
// Bound: HBM bytes.  quantize reads 4 bytes and writes 1 per element (plus
// one f32 scale per chunk), dequantize reads 1 and writes 4: at the main
// path's 1.24 G elements both move 6.18 GB, 1.845 ms at 3.35 TB/s.
//
// Design: one block of 256 threads per chunk, as the agg_opt kernels.
// quantize keeps its chunk in registers (float4 loads, at most kMaxVec of
// them a thread: 8192 f32 are 8 float4 a thread, 16384 are 16), reduces
// |x| block-wide (warp shuffles, then one value a warp through shared
// memory; max is exact, so the order does not matter), and writes the
// payload from the registers: each element crosses HBM once.  The payload
// is stored 4 bytes a thread (char4).  chunk_elems is a multiple of 4 and
// at most 256 * 4 * 16 = 16384 (the wrapper checks).
//
// Launches on the caller's stream and allocates nothing.  Each entry point
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// x: (n_chunks, chunk_elems) f32; q: the same shape, int8; scales:
// (n_chunks,) f32.  kMaxVec: float4 vectors a thread holds at most.
template <int kMaxVec>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int chunk_elems) {
  __shared__ float warp_max[kWarps];
  __shared__ float block_scale;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const float4* xv = reinterpret_cast<const float4*>(x + base);
  char4* qv = reinterpret_cast<char4*>(q + base);
  const int n_vec = chunk_elems / 4;

  float4 r[kMaxVec];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < n_vec) {
      r[k] = xv[v];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(r[k].x), fabsf(r[k].y)),
                               fmaxf(fabsf(r[k].z), fabsf(r[k].w))));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
    const float scale = m > 0.0f ? __fdiv_rn(m, 127.0f) : 1.0f;
    block_scale = scale;
    scales[blockIdx.x] = scale;
  }
  __syncthreads();
  const float scale = block_scale;

#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < n_vec) {
      const float e[4] = {r[k].x, r[k].y, r[k].z, r[k].w};
      signed char c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = fminf(fmaxf(rintf(__fdiv_rn(e[i], scale)), -127.0f),
                              127.0f);
        c[i] = static_cast<signed char>(static_cast<int>(t));
      }
      qv[v] = make_char4(c[0], c[1], c[2], c[3]);
    }
  }
}

// q: (n_chunks, chunk_elems) int8; scales: (n_chunks,) f32; x: f32 out.
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ x,
                  int chunk_elems) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * chunk_elems;
  const char4* qv = reinterpret_cast<const char4*>(q + base);
  float4* xv = reinterpret_cast<float4*>(x + base);
  const float s = scales[blockIdx.x];
  const int n_vec = chunk_elems / 4;
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const char4 c = qv[v];
    xv[v] = make_float4(__fmul_rn(static_cast<float>(c.x), s),
                        __fmul_rn(static_cast<float>(c.y), s),
                        __fmul_rn(static_cast<float>(c.z), s),
                        __fmul_rn(static_cast<float>(c.w), s));
  }
}

}  // namespace

// The wrapper has checked: chunk_elems a multiple of 4, at most 16384;
// every pointer on the card, 16-byte aligned for x, 4-byte for q.
extern "C" int quantize_chunks(const void* x, void* q, void* scales,
                               long long n_chunks, int chunk_elems,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_chunks);
  if (chunk_elems <= kThreads * 4 * 8)
    quantize_kernel<8><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), chunk_elems);
  else if (chunk_elems <= kThreads * 4 * 16)
    quantize_kernel<16><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), chunk_elems);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_chunks(const void* q, const void* scales, void* x,
                                 long long n_chunks, int chunk_elems,
                                 void* stream) {
  dequantize_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(x), chunk_elems);
  return static_cast<int>(cudaGetLastError());
}
