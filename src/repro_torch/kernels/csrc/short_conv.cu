// Hand-written Hopper (sm_90a) kernel of the depthwise short convolution,
// the sparse Toeplitz part T_sparse of SKI (paper §3.2) and Mamba's conv,
// bound to PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/short_conv.py. A source of its own, so that a
// model links it without the SKI kernels.
//
// short_conv  replaces src/repro/kernels/short_conv.py _kernel /
//   _short_conv_call (short_conv_pallas):
//     y[b, j, c] = sum_{k<m} f[c, k] x[b, j - k + left, c],
//   x, y (b, n, d) and f (d, m) contiguous, all fp32 or all bf16 (one
//   template, two entry points), x zero outside [0, n),
//   0 <= left < m a runtime argument: 0 is causal, m/2 bidirectional, and the
//   signal backward is this same kernel with the taps flipped and left
//   mirrored to m-1-left. The sum runs in fp32 over k = 0..m-1 in order,
//   and a bf16 y is rounded once at the store, as the Pallas _kernel's fp32
//   accumulator is cast to the output dtype.
//   The TPU kernel passes x under three BlockSpecs (previous, current and
//   next tile) for the halo and hands n < m (no tile covers the halo) to the
//   plain version. Here a block loads its rows and the halo itself, zero-filled
//   outside [0, n), so every n >= 1 (n < m included) runs in the kernel.
//   Bound: x read once, y written once, the taps read once, 4 (2 b n d + d m)
//   bytes: at (8, 512, 512), m = 32, 16,842,752 bytes, 5.03 us at 3.35 TB/s
//   (H100 SXM); 2 b n d m = 134 MFLOP, 2.0 us at 67 TFLOP/s fp32: bound by
//   bytes. Mamba2-2.7B's conv, x (8, 2048, 5376) bf16, m = 4, left = 0:
//   2 (2 b n d + d m) = 352,364,544 bytes, 0.105 ms; bound by bytes.
//   Design: the adjoint of csrc/ski_grad.cu's conv_tap_grad, and the conv of
//   csrc/ski.cu's pass 2. A block owns 32 channels (a warp's lanes) and 128
//   rows of one batch row. The x rows its taps reach (128 + mp - 1 of them,
//   mp = m rounded up to a multiple of 8) go to shared memory once, with
//   4-channel loads (16 bytes of fp32 or 8 of bf16, 8 threads a row) when
//   d % 4 == 0, converted to fp32, and the taps as
//   [k][channel], zero past m. Each warp owns 16 consecutive rows; a thread
//   runs the taps 8 at a time from a 23-row register window of its channel,
//   so each x value leaves shared memory once per 8 taps, and stores its 16
//   outputs (a warp's store of a row is one 128-byte line).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;       // channels of a block
constexpr int kWarps = 8;        // 8 warps, 256 threads
constexpr int kThreads = kLanes * kWarps;
constexpr int kTN = 128;         // output rows of a block
constexpr int kRows = kTN / kWarps;  // consecutive rows a thread
constexpr int kKB = 8;           // taps per register window
constexpr int kVec = 4;          // channels of a vector load
constexpr int kMaxSmem = 232448; // bytes a block may use (227 KB)
constexpr int kStaticSmem = 48 * 1024;

__host__ __device__ __forceinline__ int padded_taps(long long m) {
  return (int)((m + kKB - 1) / kKB * kKB);
}

// Dynamic shared memory of a block: its x rows and the taps.
long long conv_smem(long long m) {
  const long long mp = padded_taps(m);
  return 4LL * ((kTN + mp - 1) * kLanes + mp * kLanes);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 consecutive channels in one load (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    short_conv_kernel(const T* __restrict__ x, const T* __restrict__ filt,
                      T* __restrict__ y, long long n, long long d, int m,
                      int left, bool vec4) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mp = padded_taps(m);       // taps m..mp-1 are zero
  const int rows = kTN + mp - 1;
  float* xs = smem;                    // [rows][kLanes]
  float* fs = xs + rows * kLanes;      // [mp][kLanes]
  const long long c0 = blockIdx.x * (long long)kLanes;
  const long long j0 = blockIdx.y * (long long)kTN;
  const long long bi = blockIdx.z;
  const T* xb = x + bi * n * d;
  // tile row q holds x row j0 + left - (mp - 1) + q
  const long long xr0 = j0 + left - (mp - 1);
  if (vec4) {
    // 8 threads a row, 4 channels each; with d % 4 == 0 a group of 4
    // channels lies wholly below d or wholly past it
    const int sub = threadIdx.x % (kLanes / kVec);
    const long long c = c0 + kVec * sub;
    for (int q = threadIdx.x / (kLanes / kVec); q < rows;
         q += kThreads / (kLanes / kVec)) {
      const long long i = xr0 + q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < d && i >= 0 && i < n)
        v = load4(xb + i * d + c);
      *reinterpret_cast<float4*>(xs + q * kLanes + kVec * sub) = v;
    }
  } else {
    const long long c = c0 + lane;
    for (int q = warp; q < rows; q += kWarps) {
      const long long i = xr0 + q;
      xs[q * kLanes + lane] =
          c < d && i >= 0 && i < n ? to_f(xb[i * d + c]) : 0.f;
    }
  }
  const long long c = c0 + lane;
  const bool cok = c < d;
  for (int k = warp; k < mp; k += kWarps)
    fs[k * kLanes + lane] = cok && k < m ? to_f(filt[c * m + k]) : 0.f;
  __syncthreads();
  // output row row0 + q with tap kb + kk reads tile row
  // row0 + q - kb - kk + mp - 1 = window element q + kKB - 1 - kk
  const int row0 = warp * kRows;
  float acc[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
  for (int kb = 0; kb < mp; kb += kKB) {
    const float* xr = xs + (row0 + mp - kb - kKB) * kLanes + lane;
    float xw[kRows + kKB - 1];
#pragma unroll
    for (int e = 0; e < kRows + kKB - 1; ++e) xw[e] = xr[e * kLanes];
    float fk[kKB];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) fk[kk] = fs[(kb + kk) * kLanes + lane];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk)
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        acc[q] = fmaf(fk[kk], xw[q + kKB - 1 - kk], acc[q]);
  }
  if (!cok) return;
  T* yb = y + bi * n * d + c;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const long long j = j0 + row0 + q;
    if (j < n) store(yb + j * d, acc[q]);
  }
}

template <typename T>
int launch(const void* x, const void* filt, void* y, long long b, long long n,
           long long d, long long m, long long left, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem = conv_smem(m);
  const long long tiles = (n + kTN - 1) / kTN;
  const long long ctiles = (d + kLanes - 1) / kLanes;
  if (smem > kMaxSmem || tiles > 65535 || b > 65535 || ctiles > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    // set on the current device at each such launch: no per-process state
    const cudaError_t e = cudaFuncSetAttribute(
        short_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // 4 channels a load: d % 4 == 0 and x aligned to the load's width
  const bool vec4 = d % kVec == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (kVec * sizeof(T)) == 0;
  const dim3 grid((unsigned)ctiles, (unsigned)tiles, (unsigned)b);
  short_conv_kernel<T><<<grid, kThreads, (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(filt),
      static_cast<T*>(y), n, d, (int)m, (int)left, vec4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of a short_conv block with m taps, bytes.
long long short_conv_smem_bytes(long long m) { return conv_smem(m); }

// x, y: (b, n, d); filt: (d, m); contiguous on the device, all fp32
// (_f32) or all bf16 (_bf16); n >= 1, 0 <= left < m. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when a block's shared memory
// would exceed the card's limit or the grid its bounds.
int short_conv_f32(const void* x, const void* filt, void* y, long long b,
                   long long n, long long d, long long m, long long left,
                   void* stream) {
  return launch<float>(x, filt, y, b, n, d, m, left, stream);
}

int short_conv_bf16(const void* x, const void* filt, void* y, long long b,
                    long long n, long long d, long long m, long long left,
                    void* stream) {
  return launch<__nv_bfloat16>(x, filt, y, b, n, d, m, left, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
