// Hand-written Hopper (sm_90a) kernels of the fused SKI-TNO backward's
// parameter cotangents (paper §3.2), bound to PyTorch through a plain C
// interface (ctypes) by src/repro_torch/kernels/ski_grad.py. All tensors are
// contiguous fp32, and every sum runs in fp32 in a fixed order (no atomics),
// so both results are bitwise the same from run to run. The signal cotangent
// needs no kernel of its own: it is the forward's pass 2 of csrc/ski.cu with
// A transposed, the taps flipped and left mirrored (kernels/ski_vjp.py).
//
// conv_tap_grad  replaces src/repro/kernels/ski_grad.py _tap_grad_kernel /
//   _tap_grad_call_impl (conv_tap_grad_pallas):
//     df[c, k] = sum_{b, j} g[b, j, c] x[b, j - k + left, c],
//   g, x (b, n, d) with x zero outside [0, n), df (d, m), 0 <= left < m.
//   The TPU kernel carries the sum over sequential grid steps. Here blocks run
//   in no order, and d / 32 = 16 channel tiles alone cannot fill 132 SMs, so
//   the b n rows are split over blocks as well: pass 1 writes each block's
//   sums to a workspace of partials (P, m, d), pass 2 adds the P partials of
//   each (c, k) in order p = 0..P-1.
//   Bound: g and x read once, df written once, 4 (2 b n d + d m) bytes: at
//   (8, 512, 512), m = 32, 16,842,752 bytes, 5.03 us at 3.35 TB/s; 2 b n d m
//   = 134 MFLOP, 2.0 us at 67 TFLOP/s fp32: bound by bytes.
//   Design: a block owns 32 channels (a warp's lanes) and 128 rows of one
//   batch row, P = b ceil(n / 128) blocks a channel tile. The x rows its taps
//   reach (128 + mp - 1 of them, zero-filled outside [0, n)) go to shared
//   memory once. Each warp owns 16 rows and holds their g in registers, and
//   runs the taps 8 at a time from a 23-row register window of x, as the
//   forward conv of csrc/ski.cu does; the 8 warps' sums of each tap are then
//   added in shared memory in warp order. Every n >= 1 (n < m included) and
//   every left in [0, m) run here: the TPU wrapper's plain fallback for
//   n < m has no counterpart.
//
// gram_grad  replaces src/repro/kernels/ski_grad.py _gram_grad_kernel /
//   _gram_grad_call (gram_grad_pallas):
//     dA[c, s, t] = sum_b gz[b, s, c] z[b, t, c],
//   gz, z (b, r, d), dA (d, r, r).
//   Bound: 4 (2 b r d + d r^2) bytes: at b = 8, r = 64, d = 512, 10,485,760
//   bytes, 3.13 us at 3.35 TB/s, four fifths of it the write of dA;
//   2 b d r^2 = 34 MFLOP, 0.5 us at 67 TFLOP/s fp32: bound by bytes.
//   Design: a block owns 8 channels (one 32-byte sector of a row of gz and
//   z), 8 rows s and 64 columns t of dA. It stages gz[b, s tile, channels]
//   and z[b, t tile, channels] of 8 batch rows at a time in shared memory,
//   and a thread keeps 16 sums (2 channels x 8 rows s at its column t),
//   adding the batch rows in order. The stores run with t innermost: 64
//   consecutive floats for each (c, s). A first version staged one batch
//   row at a time: 8 dependent round trips to memory, 20.3 us at the path
//   shape on an H100.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;       // channels of a conv_tap_grad block
constexpr int kWarps = 8;        // conv_tap_grad block: 8 warps
constexpr int kTN = 128;         // rows of a conv_tap_grad block
constexpr int kRows = kTN / kWarps;  // consecutive rows of a warp
constexpr int kKB = 8;           // taps per register window
static_assert(kKB == kWarps, "the tap sums are added one tap a warp");
constexpr int kMaxSmem = 232448; // bytes a block may use (227 KB)
constexpr int kStaticSmem = 48 * 1024;

constexpr int kGC = 8;           // gram_grad block: channels,
constexpr int kGS = 8;           // rows s,
constexpr int kGT = 64;          // columns t,
constexpr int kGB = 8;           // batch rows staged together,
constexpr int kGThreads = 256;   // threads: kGT columns x kGC / 2 channel pairs
static_assert(kGThreads == kGT * kGC / 2, "a thread takes 2 channels");

__host__ __device__ __forceinline__ int padded_taps(long long m) {
  return (int)((m + kKB - 1) / kKB * kKB);
}

// Dynamic shared memory of a conv_tap_grad block: the x rows of its taps and
// the warps' tap sums.
long long tap_grad_smem(long long m) {
  return 4LL * ((kTN + padded_taps(m) - 1) * kLanes + kWarps * kKB * kLanes);
}

__global__ void __launch_bounds__(kLanes * kWarps)
    conv_tap_grad_kernel(const float* __restrict__ g,
                         const float* __restrict__ x,
                         float* __restrict__ part, long long n, long long d,
                         int m, int left, long long tiles) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mp = padded_taps(m);       // taps m..mp-1 are computed, not kept
  const int rows = kTN + mp - 1;
  float* xs = smem;                    // [rows][kLanes]
  float* red = xs + rows * kLanes;     // [kWarps][kKB][kLanes]
  const long long p = blockIdx.y;      // partial: batch row p / tiles
  const long long bi = p / tiles;
  const long long j0 = (p - bi * tiles) * kTN;
  const long long c = blockIdx.x * (long long)kLanes + lane;
  const bool cok = c < d;
  const float* xb = x + bi * n * d + (cok ? c : 0);
  const float* gb = g + bi * n * d + (cok ? c : 0);
  // tile row q holds x row j0 + left - (mp - 1) + q
  const long long xr0 = j0 + left - (mp - 1);
  for (int q = warp; q < rows; q += kWarps) {
    const long long i = xr0 + q;
    xs[q * kLanes + lane] = cok && i >= 0 && i < n ? xb[i * d] : 0.f;
  }
  const int row0 = warp * kRows;       // this warp's rows in the tile
  float gr[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const long long j = j0 + row0 + q;
    gr[q] = cok && j < n ? gb[j * d] : 0.f;
  }
  __syncthreads();
  for (int kb = 0; kb < mp; kb += kKB) {
    // row row0 + q with tap kb + kk reads tile row
    // row0 + q - kb - kk + mp - 1 = window element q + kKB - 1 - kk
    const float* xr = xs + (row0 + mp - kb - kKB) * kLanes + lane;
    float xw[kRows + kKB - 1];
#pragma unroll
    for (int e = 0; e < kRows + kKB - 1; ++e) xw[e] = xr[e * kLanes];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        acc = fmaf(gr[q], xw[q + kKB - 1 - kk], acc);
      red[(warp * kKB + kk) * kLanes + lane] = acc;
    }
    __syncthreads();
    // warp w adds tap kb + w over the 8 warps, in warp order
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kKB + warp) * kLanes + lane];
    const int k = kb + warp;
    if (cok && k < m) part[(p * m + k) * d + c] = s;
    __syncthreads();                   // before red is written again
  }
}

// df[c, k] = sum_p part[p, k, c], p in order.
__global__ void tap_grad_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ df, long long np,
                                       long long d, int m) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= d * m) return;
  const long long k = t / d;
  const long long c = t - k * d;
  float s = 0.f;
  for (long long p = 0; p < np; ++p) s += part[p * d * m + t];
  df[c * m + k] = s;
}

__global__ void __launch_bounds__(kGThreads)
    gram_grad_kernel(const float* __restrict__ gz,
                     const float* __restrict__ z, float* __restrict__ da,
                     long long b, long long r, long long d) {
  __shared__ float gs[kGB][kGC][kGS];      // gz[b0 + bb, s0 + ss, c0 + cc]
  __shared__ float zs[kGB][kGC][kGT + 1];  // z[b0 + bb, t0 + tt, c0 + cc]
  const long long c0 = blockIdx.x * (long long)kGC;
  const long long s0 = blockIdx.y * (long long)kGS;
  const long long t0 = blockIdx.z * (long long)kGT;
  const int tl = threadIdx.x % kGT;    // this thread's column
  const int cc0 = 2 * (threadIdx.x / kGT);  // and its channels cc0, cc0 + 1
  float acc[2][kGS];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int ss = 0; ss < kGS; ++ss) acc[u][ss] = 0.f;
  for (long long b0 = 0; b0 < b; b0 += kGB) {
    // kGB batch rows' tiles at once, so that their loads are in flight
    // together; 8 consecutive channels of a row are one 32-byte sector
    for (int e = threadIdx.x; e < kGB * kGC * kGT; e += kGThreads) {
      const int cc = e % kGC, tt = (e / kGC) % kGT, bb = e / (kGC * kGT);
      const long long c = c0 + cc, t = t0 + tt, bi = b0 + bb;
      zs[bb][cc][tt] =
          c < d && t < r && bi < b ? z[(bi * r + t) * d + c] : 0.f;
    }
    for (int e = threadIdx.x; e < kGB * kGC * kGS; e += kGThreads) {
      const int cc = e % kGC, ss = (e / kGC) % kGS, bb = e / (kGC * kGS);
      const long long c = c0 + cc, s = s0 + ss, bi = b0 + bb;
      gs[bb][cc][ss] =
          c < d && s < r && bi < b ? gz[(bi * r + s) * d + c] : 0.f;
    }
    __syncthreads();
    // the batch rows in order (rows past b add exact zeros)
#pragma unroll
    for (int bb = 0; bb < kGB; ++bb)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float zv = zs[bb][cc0 + u][tl];
#pragma unroll
        for (int ss = 0; ss < kGS; ++ss)
          acc[u][ss] = fmaf(gs[bb][cc0 + u][ss], zv, acc[u][ss]);
      }
    __syncthreads();                   // before the tiles are refilled
  }
  const long long t = t0 + tl;
  if (t >= r) return;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const long long c = c0 + cc0 + u;
#pragma unroll
    for (int ss = 0; ss < kGS; ++ss) {
      const long long s = s0 + ss;
      if (c < d && s < r) da[(c * r + s) * r + t] = acc[u][ss];
    }
  }
}

}  // namespace

extern "C" {

// Floats of the conv_tap_grad workspace of partials, (P, m, d).
long long conv_tap_grad_workspace_floats(long long b, long long n,
                                         long long d, long long m) {
  return b * ((n + kTN - 1) / kTN) * m * d;
}

// g, x: (b, n, d); part: conv_tap_grad_workspace_floats(b, n, d, m) floats;
// df: (d, m); contiguous fp32 on the device; 0 <= left < m. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when a block's shared memory
// would exceed the card's limit or the grid its bounds.
int conv_tap_grad_f32(const void* g, const void* x, void* part, void* df,
                      long long b, long long n, long long d, long long m,
                      long long left, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kTN - 1) / kTN;
  const long long np = b * tiles;
  const long long smem = tap_grad_smem(m);
  if (smem > kMaxSmem || np > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kStaticSmem) {
    // set on the current device at each such launch: no per-process state
    const cudaError_t e = cudaFuncSetAttribute(
        conv_tap_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((unsigned)((d + kLanes - 1) / kLanes), (unsigned)np);
  conv_tap_grad_kernel<<<grid, kLanes * kWarps, (size_t)smem, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(x),
      static_cast<float*>(part), n, d, (int)m, (int)left, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long outs = d * m;
  tap_grad_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(df), np, d,
      (int)m);
  return static_cast<int>(cudaGetLastError());
}

// gz, z: (b, r, d); da: (d, r, r); contiguous fp32 on the device. Returns
// cudaGetLastError(), or cudaErrorInvalidValue when the grid exceeds its
// bounds.
int gram_grad_f32(const void* gz, const void* z, void* da, long long b,
                  long long r, long long d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (r + kGS - 1) / kGS, cols = (r + kGT - 1) / kGT;
  if (rows > 65535 || cols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)((d + kGC - 1) / kGC), (unsigned)rows,
                  (unsigned)cols);
  gram_grad_kernel<<<grid, kGThreads, 0, s>>>(
      static_cast<const float*>(gz), static_cast<const float*>(z),
      static_cast<float*>(da), b, r, d);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
