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
// are neither read nor written and a_last is its last valid row.
//
// Layout: the model's, read in place (the TPU wrapper transposes to
// (B*H, T, hd) in HBM).  r, k, v, w and y are (B, T, H, 64), contiguous, f32
// or bf16 (one dtype; y takes it); u (H, 64) f32; the states (B, H, 64, 64)
// f32, k-dim by v-dim.  The input state is read once, before the first
// chunk, so s_out may alias s_in.
//
// Numerics: a, rq, kd, kd * a_last and diag's products are the plain
// version's (ref.py) bit for bit; the sums run in another order (fmaf
// chains over d and j here, matrix products there), so the two agree to
// rounding.  The strict lower triangle is never computed past the
// diagonal, which is the where-semantics of the Pallas body.  Under strong
// decay a underflows and kd becomes inf: the output holds inf and NaN in the
// same places as the plain version's (a sum's class does not depend on its
// order).  -fmad=false (the build's flag) keeps every written a * b + c
// unfused; the dot products use fmaf explicitly.
//
// Bound: at the serving shape (B 8, T 2048, H 40, f32) the four products
// (the strict triangle of rq kd^T and of att v, rq S and kd^T v) and the
// elementwise work are 16.5 GFLOP on the SIMT f32 units (0.247 ms at 67
// TFLOP/s) and r, k, v, w, y and the states cross HBM once (0.85 GB, 0.254
// ms at 3.35 TB/s): bytes bind, narrowly.
//
// Design (a simple kernel that is right; wgmma for the products, TMA and a
// split over chunks come later): one block of 256 threads per (h, b),
// walking the chunks in order with S (16 KB) in shared memory; each chunk's
// r/rq, k/kd, v, w and the score tile att live in shared memory too (97 KB
// in all, so two blocks an SM).  Thread (ty, tx) of a 16 x 16 grid owns rows
// 4ty..4ty+3 and columns tx + 16j of each 64 x 64 product; rows of r/rq,
// k/kd and att have a stride of 65 floats, so a column walk hits distinct
// banks.  a is a serial product over the chunk's rows, one thread a
// channel; diag is a warp-shuffle sum, one warp a row.
//
// Launches on the caller's stream and allocates nothing.  The entry point
// returns cudaGetLastError() (or cudaErrorInvalidValue for shapes it does
// not take) so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCT = 64;          // tokens per chunk
constexpr int kHD = 64;          // head dim
constexpr int kP = kHD + 1;      // padded row stride of R, K and A
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemBytes =
    sizeof(float) * (3 * kCT * kP + 2 * kCT * kHD + kHD * kHD + kCT + kHD);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* s_in, T* y,
                 float* s_out, int seq, int nh) {
  extern __shared__ float smem[];
  float* R = smem;               // r, then rq                [kCT][kP]
  float* K = R + kCT * kP;       // k, then kd, then kd*a_last [kCT][kP]
  float* A = K + kCT * kP;       // att = rq kd^T              [kCT][kP]
  float* V = A + kCT * kP;       // v                          [kCT][kHD]
  float* W = V + kCT * kHD;      // w                          [kCT][kHD]
  float* S = W + kCT * kHD;      // state                      [kHD][kHD]
  float* D = S + kHD * kHD;      // diag                       [kCT]
  float* AL = D + kCT;           // a_last                     [kHD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = 4 * ty;         // the thread's first row of a product
  const int64_t row = static_cast<int64_t>(nh) * kHD;     // one t
  const int64_t base = static_cast<int64_t>(b) * seq * row + h * kHD;
  const int64_t sbase = (static_cast<int64_t>(b) * nh + h) * kHD * kHD;

  for (int e = tid; e < kHD * kHD; e += kThreads) S[e] = s_in[sbase + e];
  const float u0 = u[h * kHD + lane], u1 = u[h * kHD + lane + 32];

  for (int c0 = 0; c0 < seq; c0 += kCT) {
    const int n = min(kCT, seq - c0);
    __syncthreads();             // the last chunk's tiles are consumed
    for (int e = tid; e < n * kHD; e += kThreads) {
      const int i = e / kHD, d = e % kHD;
      const int64_t g = base + (c0 + i) * row + d;
      R[i * kP + d] = to_f32(r[g]);
      K[i * kP + d] = to_f32(k[g]);
      V[i * kHD + d] = to_f32(v[g]);
      W[i * kHD + d] = to_f32(w[g]);
    }
    __syncthreads();

    // diag_i = sum_d r (u k), one warp a row
    for (int i = warp; i < n; i += kWarps) {
      float p = R[i * kP + lane] * (u0 * K[i * kP + lane]);
      const float q = R[i * kP + lane + 32] * (u1 * K[i * kP + lane + 32]);
      p = p + q;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) D[i] = p;
    }
    __syncthreads();

    // a in row order, one thread a channel: rq = r a_prev, kd = k / a
    if (tid < kHD) {
      float a = 1.0f;
      for (int i = 0; i < n; ++i) {
        R[i * kP + tid] = R[i * kP + tid] * a;
        a = a * W[i * kHD + tid];
        K[i * kP + tid] = K[i * kP + tid] / a;
      }
      AL[tid] = a;
    }
    __syncthreads();

    // att[i][j] = rq_i . kd_j (read only for j < i < n)
    if (i0 < n) {
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < kHD; ++d) {
        float a4[4], b4[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) a4[ii] = R[(i0 + ii) * kP + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b4[jj] = K[(tx + 16 * jj) * kP + d];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[ii][jj] = fmaf(a4[ii], b4[jj], acc[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          A[(i0 + ii) * kP + tx + 16 * jj] = acc[ii][jj];
    }
    __syncthreads();

    // kd <- kd * a_last (read by the state update below)
    for (int e = tid; e < n * kHD; e += kThreads) {
      const int i = e / kHD, d = e % kHD;
      K[i * kP + d] = K[i * kP + d] * AL[d];
    }
    // y_i = sum_{j<i} att_ij v_j + rq_i S + diag_i v_i
    if (i0 < n) {
      float acc[4][4], acc2[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) acc[ii][ee] = acc2[ii][ee] = 0.0f;
      const int jmax = min(i0 + 3, n);     // j < i for the last row
      for (int j = 0; j < jmax; ++j) {
        float b4[4];
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) b4[ee] = V[j * kHD + tx + 16 * ee];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          if (j < i0 + ii) {                // never past the diagonal
            const float a = A[(i0 + ii) * kP + j];
#pragma unroll
            for (int ee = 0; ee < 4; ++ee)
              acc[ii][ee] = fmaf(a, b4[ee], acc[ii][ee]);
          }
        }
      }
#pragma unroll 4
      for (int d = 0; d < kHD; ++d) {
        float a4[4], b4[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) a4[ii] = R[(i0 + ii) * kP + d];
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) b4[ee] = S[d * kHD + tx + 16 * ee];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int ee = 0; ee < 4; ++ee)
            acc2[ii][ee] = fmaf(a4[ii], b4[ee], acc2[ii][ee]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        if (i < n) {
#pragma unroll
          for (int ee = 0; ee < 4; ++ee) {
            const int e = tx + 16 * ee;
            const float dv = D[i] * V[i * kHD + e];
            store(&y[base + (c0 + i) * row + e],
                  (acc[ii][ee] + acc2[ii][ee]) + dv);
          }
        }
      }
    }
    __syncthreads();

    // S <- a_last * S + sum_j (kd_j a_last)^T v_j, rows 4ty.., cols tx+16ee
    {
      float acc[4][4];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) acc[dd][ee] = 0.0f;
      for (int j = 0; j < n; ++j) {
        float a4[4], b4[4];
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) a4[dd] = K[j * kP + i0 + dd];
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) b4[ee] = V[j * kHD + tx + 16 * ee];
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int ee = 0; ee < 4; ++ee)
            acc[dd][ee] = fmaf(a4[dd], b4[ee], acc[dd][ee]);
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float al = AL[i0 + dd];
#pragma unroll
        for (int ee = 0; ee < 4; ++ee) {
          float* s = &S[(i0 + dd) * kHD + tx + 16 * ee];
          const float decayed = al * *s;
          *s = decayed + acc[dd][ee];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kHD * kHD; e += kThreads) s_out[sbase + e] = S[e];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s_in, void* y, void* s_out,
                   int B, int T_, int nh, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(nh, B);
  rwkv_scan_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s_in),
      static_cast<T*>(y), static_cast<float*>(s_out), T_, nh);
  return cudaGetLastError();
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
