// Hand-written Hopper (sm_90a) kernels of the causal FD-TNO forward and
// backward, bound to PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/fd_fused.py. Three are elementwise or a short
// reduction over the batch, two do a row's short FFTs in shared memory; all
// five are bound by device-memory bytes, never by arithmetic.
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
//   The backward runs it again with the conjugate spectrum (the wrapper
//   passes a physically conjugated k, never a conj view).
//
// fd_khat_grad  replaces src/repro/kernels/fd_fused.py _khat_grad_kernel /
//   _khat_grad_call (fd_khat_grad_pallas): d[j] = sum_b g[b, j] * conj(x[b, j])
//   on the channel-major (b, d, n+1) complex64 spectra of the backward,
//   into a fresh (d, n+1) complex64 tensor that goes straight into irfft.
//   The Pallas kernel accumulates the batch over an innermost sequential
//   grid axis into its resident output block; Hopper blocks run in no
//   order, so the batch sum is a loop inside the thread instead.
//   Bound: 8 bytes x 2 b row read + 8 bytes x row written, 8 flops per
//   complex product-add. At (8, 512, 513): 33,619,968 + 2,101,248 =
//   35,721,216 bytes, 10.66 us at 3.35 TB/s (the byte count of fd_mul).
//   Design: one thread per pair of output elements loops over b with fp32
//   accumulators; 16-byte loads and stores (two complex values) when the
//   row length is even, neighbouring threads on neighbouring addresses,
//   as fd_mul_vec2; a scalar path for odd rows and misaligned pointers.
//   No atomics: every output element is summed by one thread in batch
//   order 0..b-1, so the gradient is bitwise the same from run to run.
//
// causal_spectrum  replaces, with hilbert_window, the whole Hilbert
//   completion around src/repro/kernels/fd_fused.py _window_call
//   (causal_khat_planes: irfft -> hilbert_window_pallas -> rfft) in one
//   launch: k = rfft(w . irfft(u, 2n), 2n) of a (d, n+1) real response u,
//   into a (d, n+1) complex64 tensor (conj(k) for the backward's conjugate
//   spectrum, so no conj_physical follows it).
// causal_spectrum_adjoint  replaces the backward's pull-back of the
//   spectrum cotangent (fd_fused.py _fd_bwd: irfft -> hilbert_window_pallas
//   -> the irfft VJP) in one launch: dkr = irfft^T(w . irfft(dk, 2n)) =
//   (c / 2n) . Re rfft(w . irfft(dk, 2n)), c = 1 at bins 0 and n and 2
//   between, from the (d, n+1) complex64 cotangent dk (the imaginary parts
//   of bins 0 and n dropped: a real signal's spectrum has none there).
//   Bound, each: 12 bytes x d(n+1) (4 read + 8 written, or 8 + 4) and two
//   real FFTs of length 2n a row, about 5 x 2n log2(2n) flops: at the path,
//   d = 512, n = 512, 3,151,872 bytes, 0.94 us at 3.35 TB/s, against 26
//   MFLOP, 0.39 us at 67 TFLOP/s. Bound by bytes.
//   Design: n = M is a power of two, 1 <= M <= kCsMaxHalf (the route
//   backend.causal_spectrum_route sends every other length to the
//   three-launch window path). A block takes `rows` whole rows (one at M >=
//   kCsRowElems, enough for kCsRowElems points below) and keeps them in
//   shared memory from the load to the store: a row is read once, coalesced,
//   kCsLoads loads in flight a thread (the launch is latency-bound: one wave
//   of short blocks), and written once; nothing between the two transforms
//   goes to device memory. A real transform of length 2M is a complex one of
//   length M: the inverse packs E + iO from bins m and M - m with the
//   twiddle exp(+2 pi i m / 2M), runs an inverse complex FFT and leaves the
//   even samples in the real parts and the odd ones in the imaginary parts.
//   That packed layout is exactly the forward transform's input, so the lag
//   window (and the 1/M of the inverse) is one multiply per component, and
//   the forward complex FFT and its post-twiddle X_m = E_m + exp(-2 pi i m /
//   2M) O_m follow. Both complex FFTs are Stockham passes between two
//   shared-memory buffers with __syncthreads() between passes: a first pass
//   of radix 2^(log2 M mod 3) (radix 8 when that is 0) whose twiddles are
//   all 1 and whose loads apply the pack (inverse) or the window (forward),
//   then radix-8 passes: 3 a transform at the path's M = 512, 7 barriers a
//   block in all. M / 4 threads a row (at most kCsMaxThreads): the radix-8
//   passes keep M / 8 of them busy, the load, the table and the post-twiddle
//   all. The twiddles exp(-2 pi i k / 2M), k < M, are built by each block
//   with sincospif at an exact argument k / M (accurate to fp32 rounding; the
//   table's upper half is its lower half negated) while its loads are in
//   flight. No atomics and one fixed order of operations: two calls give the
//   same bits.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
// causal_spectrum: a block takes whole rows, at least kCsRowElems points
constexpr int kCsRowElems = 512;
// causal_spectrum: most threads a block
constexpr int kCsMaxThreads = 512;
// causal_spectrum: loads in flight a thread while a block stages its rows
constexpr int kCsLoads = 16;
// causal_spectrum: largest half-length M = n (2n = 8192)
constexpr int kCsMaxHalf = 4096;
// the shared memory a block may use without raising the attribute
constexpr long long kSmemDefault = 48 * 1024;
// devices with their own shared-memory attribute
constexpr int kMaxDevices = 64;

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

// Re and Im of g * conj(x), added into (re, im).
__device__ __forceinline__ void acc_gconjx(float2 g, float2 x, float& re,
                                           float& im) {
  re += g.x * x.x + g.y * x.y;
  im += g.y * x.x - g.x * x.y;
}

// One thread per output pair (two complex values per float4), looping over
// the batch rows in order: a fixed sum order and no atomics.
__global__ void fd_khat_grad_vec2(const float4* __restrict__ g,
                                  const float4* __restrict__ x,
                                  float4* __restrict__ out, long long b,
                                  long long row2) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < row2; j += (long long)gridDim.x * blockDim.x) {
    float lr = 0.f, li = 0.f, hr = 0.f, hi = 0.f;
#pragma unroll 4
    for (long long bi = 0; bi < b; ++bi) {
      const float4 a = g[bi * row2 + j];
      const float4 c = x[bi * row2 + j];
      acc_gconjx(make_float2(a.x, a.y), make_float2(c.x, c.y), lr, li);
      acc_gconjx(make_float2(a.z, a.w), make_float2(c.z, c.w), hr, hi);
    }
    out[j] = make_float4(lr, li, hr, hi);
  }
}

__global__ void fd_khat_grad_scalar(const float2* __restrict__ g,
                                    const float2* __restrict__ x,
                                    float2* __restrict__ out, long long b,
                                    long long row) {
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       j < row; j += (long long)gridDim.x * blockDim.x) {
    float re = 0.f, im = 0.f;
#pragma unroll 4
    for (long long bi = 0; bi < b; ++bi) {
      acc_gconjx(g[bi * row + j], x[bi * row + j], re, im);
    }
    out[j] = make_float2(re, im);
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

// ------------------------------------------------------- causal spectrum
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cconj(float2 a) {
  return make_float2(a.x, -a.y);
}
// -i v for a forward transform, +i v for an inverse one
template <bool kInverse>
__device__ __forceinline__ float2 mul_mi(float2 v) {
  return kInverse ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
}

// exp(-2 pi i k / 2M) for 0 <= k < 2M from the table t[k] = exp(-2 pi i k
// / 2M), k < M (the upper half is the lower half negated); conjugated for
// an inverse transform.
template <bool kInverse>
__device__ __forceinline__ float2 twiddle(const float2* t, int k, int half) {
  float2 w = k < half ? t[k] : make_float2(-t[k - half].x, -t[k - half].y);
  return kInverse ? cconj(w) : w;
}

// In-register DFT of R = 1, 2, 4 or 8 points, exp(-+2 pi i / R); R = 8 as
// two radix-4 DFTs of the even and odd points and a radix-2 step.
template <int R, bool kInverse>
__device__ __forceinline__ void dft(float2* v) {
  if (R == 2) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
  } else if (R == 4) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]);
    const float2 t3 = mul_mi<kInverse>(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[1] = cadd(t1, t3);
    v[2] = csub(t0, t2);
    v[3] = csub(t1, t3);
  } else if (R == 8) {
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    dft<4, kInverse>(e);
    dft<4, kInverse>(o);
    constexpr float h = 0.70710678118654752f;    // 1 / sqrt(2)
    // o_k exp(-+2 pi i k / 8), k = 1, 2, 3
    const float2 m1 = mul_mi<kInverse>(o[1]);
    o[1] = make_float2(h * (o[1].x + m1.x), h * (o[1].y + m1.y));
    o[2] = mul_mi<kInverse>(o[2]);
    const float2 m3 = mul_mi<kInverse>(o[3]);
    o[3] = make_float2(h * (m3.x - o[3].x), h * (m3.y - o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = cadd(e[k], o[k]);
      v[k + 4] = csub(e[k], o[k]);
    }
  }
}

// The lag window w(t) (1 at t = 0 and t = M, 2 between, 0 beyond) times
// the inverse FFT's 1/M (all powers of two: exact).
__device__ __forceinline__ float window_scale(int t, int half) {
  const float inv = 1.f / (float)half;
  return (t == 0 || t == half) ? inv : (t < half ? 2.f * inv : 0.f);
}

// What the first pass of a transform reads: its plain input; the pack of
// the inverse real FFT (kPack); the window of the forward one (kWindow).
enum CsLoad { kPlain, kPack, kWindow };

// Element m of a row of the first pass's input. kPack: z_m = E_m + i O_m,
// E_m = (X_m + conj X_{M-m}) / 2, O_m = (X_m - conj X_{M-m}) / 2
// exp(+2 pi i m / 2M), from the staged bins X (M+1 of them). kWindow: z_m
// holds samples 2m (real part) and 2m+1 (imaginary part) of the length-2M
// inverse times M; each is multiplied by its window_scale.
template <int kLoad>
__device__ __forceinline__ float2 load_input(const float2* row, int m,
                                             const float2* t, int half) {
  if (kLoad == kPack) {
    // bins 0 and M keep their real parts only (both are read at m = 0)
    float2 xm = row[m];
    float2 xc = cconj(row[half - m]);
    if (m == 0) xm.y = xc.y = 0.f;
    const float2 ev = make_float2(0.5f * (xm.x + xc.x), 0.5f * (xm.y + xc.y));
    const float2 ov = cmul(make_float2(0.5f * (xm.x - xc.x),
                                       0.5f * (xm.y - xc.y)), cconj(t[m]));
    return make_float2(ev.x - ov.y, ev.y + ov.x);
  }
  if (kLoad == kWindow) {
    const float2 v = row[m];
    return make_float2(v.x * window_scale(2 * m, half),
                       v.y * window_scale(2 * m + 1, half));
  }
  return row[m];
}

// One Stockham pass of radix R of a length-M complex FFT (forward, or
// inverse without the 1/M) on each of `rows` rows of stride p: butterfly j
// of a row reads input element j + r q, q = M / R, multiplies input r by
// the twiddle exp(-+2 pi i (j mod ns) r / (ns R)), and writes output r to
// dst[(j - j mod ns) R + j mod ns + r ns]. ns is the length of the
// sub-transforms already done (1 in the first pass, whose twiddles are 1).
template <int R, bool kInverse, int kLoad>
__device__ void stockham_pass(const float2* __restrict__ src,
                              float2* __restrict__ dst,
                              const float2* __restrict__ t, int half, int lm,
                              int p, int rows, int ns) {
  constexpr int lr = R == 8 ? 3 : (R == 4 ? 2 : (R == 2 ? 1 : 0));
  const int lq = lm - lr;              // log2 q
  const int q = 1 << lq;
  const int step = (2 * half) >> (lr + __ffs(ns) - 1);  // 2M / (ns R)
  for (int i = threadIdx.x; i < rows << lq; i += blockDim.x) {
    const int row = i >> lq;
    const int j = i & (q - 1);
    const int k = j & (ns - 1);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = load_input<kLoad>(src + row * p, j + r * q, t, half);
    if (k != 0) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], twiddle<kInverse>(t, k * r * step, half));
    }
    dft<R, kInverse>(v);
    float2* o = dst + row * p + ((j - k) << lr) + k;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r * ns] = v[r];
  }
}

// A length-M complex FFT of each row from buffer a, the first pass reading
// through kLoad; returns the buffer that holds the result. The passes: a
// first one of radix 2^(log2 M mod 3) (radix 8 when that is 0 and M > 1,
// radix 1, a pointwise copy, at M = 1), then radix-8 passes;
// __syncthreads() after each.
template <bool kInverse, int kLoad>
__device__ float2* complex_fft(float2* a, float2* b, const float2* t,
                               int half, int lm, int p, int rows) {
  const int r0 = lm % 3;
  if (r0 == 1) {
    stockham_pass<2, kInverse, kLoad>(a, b, t, half, lm, p, rows, 1);
  } else if (r0 == 2) {
    stockham_pass<4, kInverse, kLoad>(a, b, t, half, lm, p, rows, 1);
  } else if (lm == 0) {
    stockham_pass<1, kInverse, kLoad>(a, b, t, half, lm, p, rows, 1);
  } else {
    stockham_pass<8, kInverse, kLoad>(a, b, t, half, lm, p, rows, 1);
  }
  __syncthreads();
  for (int ns = r0 == 0 ? (lm == 0 ? 1 : 8) : 1 << r0; ns < half; ns *= 8) {
    float2* tmp = a; a = b; b = tmp;
    stockham_pass<8, kInverse, kPlain>(a, b, t, half, lm, p, rows, ns);
    __syncthreads();
  }
  return b;
}

// rows [row0, row0 + nrows) of the (d, M+1) input: the causal spectrum
// (kAdjoint false: `in` real, `out` complex64, conjugated if conj) or its
// adjoint (kAdjoint true: `in` complex64, `out` real). Shared memory: the
// twiddle table (M float2), then two buffers of `rows` rows of M+1 float2.
template <bool kAdjoint>
__device__ void causal_spectrum_rows(const void* __restrict__ in,
                                     void* __restrict__ out, long long d,
                                     int half, int lm, int rows, bool conj) {
  extern __shared__ float2 cs_smem[];
  const int p = half + 1;
  float2* t = cs_smem;
  float2* a = t + half;
  float2* b = a + rows * p;
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)(d - row0 < rows ? d - row0 : rows);
  const long long base = row0 * p;          // the block's rows are contiguous
  const int count = nrows * p;
  // stage the rows, kCsLoads loads in flight a thread (the first batch's
  // while the twiddle table is built)
  for (int e0 = threadIdx.x; e0 < count; e0 += kCsLoads * blockDim.x) {
    float2 v[kCsLoads];
#pragma unroll
    for (int u = 0; u < kCsLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) {
        v[u] = kAdjoint
                   ? static_cast<const float2*>(in)[base + e]
                   : make_float2(static_cast<const float*>(in)[base + e], 0.f);
      }
    }
    if (e0 == threadIdx.x) {     // every thread with an entry (k < M < count)
      for (int k = threadIdx.x; k < half; k += blockDim.x) {
        float s, c;
        sincospif((float)k / (float)half, &s, &c);
        t[k] = make_float2(c, -s);
      }
    }
#pragma unroll
    for (int u = 0; u < kCsLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < count) a[e] = v[u];
    }
  }
  __syncthreads();
  // the inverse real FFT as a packed complex one, then the window and the
  // forward complex FFT on its packed output
  float2* z = complex_fft<true, kPack>(a, b, t, half, lm, p, nrows);
  z = complex_fft<false, kWindow>(z, z == a ? b : a, t, half, lm, p, nrows);
  // unpack the forward real FFT: X_m = E_m + exp(-2 pi i m / 2M) O_m,
  // E_m = (Z_m + conj Z_{M-m}) / 2, O_m = -i (Z_m - conj Z_{M-m}) / 2
  const float inv = 1.f / (float)half;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int row = nrows == 1 ? 0 : e / p, m = e - row * p;
    const float2 zm = z[row * p + (m & (half - 1))];
    const float2 zc = cconj(z[row * p + ((half - m) & (half - 1))]);
    const float2 ev = make_float2(0.5f * (zm.x + zc.x), 0.5f * (zm.y + zc.y));
    const float2 ov = mul_mi<false>(
        make_float2(0.5f * (zm.x - zc.x), 0.5f * (zm.y - zc.y)));
    const float2 w = m < half ? t[m] : make_float2(-1.f, 0.f);
    const float2 x = cadd(ev, cmul(w, ov));
    if (kAdjoint) {
      const float c = (m == 0 || m == half) ? 0.5f : 1.f;
      static_cast<float*>(out)[base + e] = x.x * c * inv;
    } else {
      static_cast<float2*>(out)[base + e] = conj ? cconj(x) : x;
    }
  }
}

__global__ void causal_spectrum_kernel(const float* __restrict__ u,
                                       float2* __restrict__ out, long long d,
                                       int half, int lm, int rows, bool conj) {
  causal_spectrum_rows<false>(u, out, d, half, lm, rows, conj);
}

__global__ void spectrum_adjoint_kernel(const float2* __restrict__ dk,
                                        float* __restrict__ out, long long d,
                                        int half, int lm, int rows) {
  causal_spectrum_rows<true>(dk, out, d, half, lm, rows, false);
}

// The launch of either causal-spectrum kernel on (d, M+1) rows: rows a
// block, threads a block, dynamic shared memory (bytes).
struct CsLaunch {
  int rows, threads;
  long long smem;
};

CsLaunch cs_launch(long long d, int half) {
  long long rows = half >= kCsRowElems ? 1 : kCsRowElems / half;
  if (rows > d) rows = d;
  long long threads = (rows * half / 4 + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kCsMaxThreads) threads = kCsMaxThreads;
  return {(int)rows, (int)threads,
          8LL * half + 16LL * rows * (half + 1)};
}

// log2 of M when M is a power of two in [1, kCsMaxHalf], else -1
int cs_log2(long long half) {
  if (half < 1 || half > kCsMaxHalf || (half & (half - 1)) != 0) return -1;
  int lm = 0;
  while ((1LL << lm) < half) ++lm;
  return lm;
}

// Raise kernel's dynamic shared memory attribute to smem bytes on the
// current device, once a device (set remembers what was set).
cudaError_t allow_smem(const void* kernel, long long smem, long long* set) {
  if (smem <= kSmemDefault) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) set[dev] = smem;
  return e;
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

// g, x: (b, row) contiguous complex64; out: (row,) contiguous complex64.
// Returns cudaGetLastError().
int fd_khat_grad_c64(const void* g, const void* x, void* out, long long b,
                     long long row, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = row % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    fd_khat_grad_vec2<<<grid_for(row / 2, 1), kThreads, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(x),
        static_cast<float4*>(out), b, row / 2);
  } else {
    fd_khat_grad_scalar<<<grid_for(row, 1), kThreads, 0, s>>>(
        static_cast<const float2*>(g), static_cast<const float2*>(x),
        static_cast<float2*>(out), b, row);
  }
  return static_cast<int>(cudaGetLastError());
}

// u: (d, n+1) contiguous fp32; out: (d, n+1) contiguous complex64, k or
// conj(k) when conj != 0. n a power of two, 1 <= n <= kCsMaxHalf (else
// cudaErrorInvalidValue, no launch). Returns cudaGetLastError().
int causal_spectrum_f32(const void* u, void* out, long long d, long long n,
                        int conj, void* stream) {
  const int lm = cs_log2(n);
  if (lm < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  static long long smem_set[kMaxDevices] = {};
  const CsLaunch l = cs_launch(d, (int)n);
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(causal_spectrum_kernel), l.smem,
      smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  causal_spectrum_kernel<<<(unsigned)((d + l.rows - 1) / l.rows), l.threads,
                           (size_t)l.smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float2*>(out), d, (int)n, lm,
      l.rows, conj != 0);
  return static_cast<int>(cudaGetLastError());
}

// dk: (d, n+1) contiguous complex64; out: (d, n+1) contiguous fp32. n as
// for causal_spectrum_f32. Returns cudaGetLastError().
int causal_spectrum_adjoint_f32(const void* dk, void* out, long long d,
                                long long n, void* stream) {
  const int lm = cs_log2(n);
  if (lm < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  static long long smem_set[kMaxDevices] = {};
  const CsLaunch l = cs_launch(d, (int)n);
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(spectrum_adjoint_kernel), l.smem,
      smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  spectrum_adjoint_kernel<<<(unsigned)((d + l.rows - 1) / l.rows), l.threads,
                            (size_t)l.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(dk), static_cast<float*>(out), d, (int)n, lm,
      l.rows);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
