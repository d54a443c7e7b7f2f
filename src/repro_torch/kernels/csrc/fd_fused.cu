// Hand-written Hopper (sm_90a) kernels of the causal FD-TNO forward, bound
// to PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/fd_fused.py. Both are elementwise, so both are
// bound by device-memory bytes, never by arithmetic.
//
// hilbert_window  replaces src/repro/kernels/fd_fused.py _window_kernel /
//   _window_call (hilbert_window_pallas): out[c, t] = kt[c, t] * w(t) on
//   kt (d, 2n), with w = 1 at t in {0, n}, 2 for 0 < t < n and 0 beyond.
//   Bound: the lags past n are zero whatever kt holds there, so the function
//   reads lags 0..n only: 4 bytes x d(n+1) read + 4 bytes x 2dn written, d(n+1)
//   multiplies. At the serving shape (512, 1024) that is 3,147,776 bytes,
//   0.94 us at 3.35 TB/s (H100 SXM).
//   Design: the window comes from the column index in registers (as the
//   Pallas kernel builds it from iota); a thread whose lags all lie past n
//   stores zeros without loading kt, so only the live half of kt is read.
//   (The Pallas kernel computes kt * 0 there, which is NaN for a non-finite
//   kt; the time response of a finite spectrum is finite, so the two agree
//   on every input this path gives them.) 16-byte float4 loads and stores
//   when the row length allows, neighbouring threads on neighbouring
//   addresses; one block row per kt row, grid-stride.
//
// fd_mul  replaces src/repro/kernels/fd_fused.py _mul_kernel / _mul_call
//   (fd_spectral_multiply_pallas): y[b, j] = x[b, j] * k[j], complex.
//   The TPU kernel reads and writes separate re/im planes because Pallas has
//   no complex type, which costs a plane split before it and a re + 1j*im
//   assembly after it. Here x and y are the interleaved complex64 tensors
//   that torch.fft produces and consumes, one float2 per element.
//   Bound: 8 bytes read + 8 written per element of x plus one read of k.
//   At (8, 512, 513) that is 35.7 MB, 10.7 us at 3.35 TB/s.
//   Design: one thread per k element loops over the batch rows, so k is
//   read from memory once and the rows' loads are independent and in
//   flight together; 16-byte loads and stores (two complex values) when
//   the row length is even, neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float lag_window(long long t, long long n) {
  return (t == 0 || t == n) ? 1.0f : (t < n ? 2.0f : 0.0f);
}

__global__ void hilbert_window_vec4(const float4* __restrict__ kt,
                                    float4* __restrict__ out, long long d,
                                    long long n) {
  const long long tt4 = n / 2;  // 2n / 4 float4 per row
  for (long long row = blockIdx.y; row < d; row += gridDim.y) {
    const float4* src = kt + row * tt4;
    float4* dst = out + row * tt4;
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         j < tt4; j += (long long)gridDim.x * blockDim.x) {
      const long long t = 4 * j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t <= n) {
        v = src[j];
        v.x *= lag_window(t, n);
        v.y *= lag_window(t + 1, n);
        v.z *= lag_window(t + 2, n);
        v.w *= lag_window(t + 3, n);
      }
      dst[j] = v;
    }
  }
}

__global__ void hilbert_window_scalar(const float* __restrict__ kt,
                                      float* __restrict__ out, long long d,
                                      long long n) {
  const long long tt = 2 * n;
  for (long long row = blockIdx.y; row < d; row += gridDim.y) {
    for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         t < tt; t += (long long)gridDim.x * blockDim.x) {
      out[row * tt + t] = t <= n ? kt[row * tt + t] * lag_window(t, n) : 0.f;
    }
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 c) {
  return make_float2(a.x * c.x - a.y * c.y, a.x * c.y + a.y * c.x);
}

// One thread per k element (two complex values per float4): k is read once
// and the batch rows' loads are independent, so they are all in flight.
__global__ void fd_mul_vec2(const float4* __restrict__ x,
                            const float4* __restrict__ k,
                            float4* __restrict__ y, long long b,
                            long long row2) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < row2; j += (long long)gridDim.x * blockDim.x) {
    const float4 c = k[j];
#pragma unroll 4
    for (long long bi = 0; bi < b; ++bi) {
      const float4 a = x[bi * row2 + j];
      const float2 lo = cmul(make_float2(a.x, a.y), make_float2(c.x, c.y));
      const float2 hi = cmul(make_float2(a.z, a.w), make_float2(c.z, c.w));
      y[bi * row2 + j] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
}

__global__ void fd_mul_scalar(const float2* __restrict__ x,
                              const float2* __restrict__ k,
                              float2* __restrict__ y, long long b,
                              long long row) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < row; j += (long long)gridDim.x * blockDim.x) {
    const float2 c = k[j];
#pragma unroll 4
    for (long long bi = 0; bi < b; ++bi) {
      y[bi * row + j] = cmul(x[bi * row + j], c);
    }
  }
}

dim3 grid_for(long long cols, long long rows) {
  long long gx = (cols + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (gx > 1024) gx = 1024;
  long long gy = rows < kMaxGridY ? rows : kMaxGridY;
  if (gy < 1) gy = 1;
  return dim3((unsigned)gx, (unsigned)gy);
}

}  // namespace

extern "C" {

// kt, out: (d, 2n) contiguous fp32 on the device. Returns cudaGetLastError().
int hilbert_window_f32(const void* kt, void* out, long long d, long long n,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(kt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    hilbert_window_vec4<<<grid_for(n / 2, d), kThreads, 0, s>>>(
        static_cast<const float4*>(kt), static_cast<float4*>(out), d, n);
  } else {
    hilbert_window_scalar<<<grid_for(2 * n, d), kThreads, 0, s>>>(
        static_cast<const float*>(kt), static_cast<float*>(out), d, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: (b, row) contiguous complex64; k: (row,) contiguous complex64.
// Returns cudaGetLastError().
int fd_mul_c64(const void* x, const void* k, void* y, long long b,
               long long row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = row % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) {
    fd_mul_vec2<<<grid_for(row / 2, 1), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const float4*>(k),
        static_cast<float4*>(y), b, row / 2);
  } else {
    fd_mul_scalar<<<grid_for(row, 1), kThreads, 0, s>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(k),
        static_cast<float2*>(y), b, row);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
