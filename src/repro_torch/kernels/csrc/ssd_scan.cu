// Hand-written Hopper (sm_90a) kernel of the Mamba-2 SSD chunked scan,
// bound to PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/ssd_scan.py.
//
// ssd_scan  replaces src/repro/kernels/ssd_scan.py _kernel /
//   ssd_scan_pallas. Per (batch row, head), over chunks of q = min(chunk, n)
//   positions in order, with the (p, s) state S carried across chunks:
//     cum    = inclusive cumsum of dt a within the chunk
//     L[i,j] = exp(cum_i - cum_j) for i >= j, else 0
//     y      = ((C B^T) . L . dt_j) X + exp(cum_i) (C S^T) + D X
//     S     <- exp(cum_last) S + X^T (B . exp(cum_last - cum) dt)
//   x (b, n, h, p) and B, C (b, n, g, s) in bf16 or fp32 (the same type),
//   dt (b, n, h), a (h,) and D (h,) fp32, y (b, n, h, p) in x's type; head i
//   reads group i / (h/g). All arithmetic is fp32, as in the Pallas kernel;
//   the cumsum runs in order (one thread), as the plain version's.
//   The TPU kernel moves (b, h) to the front with moveaxis copies, repeats B
//   and C to every head, runs the chunk axis as a sequential grid dimension
//   and asserts n % q == 0. Here a block reads x, dt, B and C in place from
//   their (b, n, h, .) and (b, n, g, .) layouts, loops over the chunks
//   itself, and masks a ragged last chunk (rows past n read as zero, dt = 0
//   there: no decay and no input), which is the plain version's zero
//   padding. Every n >= 1 runs here: no fallback.
//   Bound: at the Mamba2-2.7B path shape (x (8, 2048, 80, 64) bf16, B and C
//   (8, 2048, 1, 128), q = 128) the chunked form needs q (q + 1) p flops a
//   head and chunk for the lower-triangular scores . X, 4 q s p for C S^T
//   and the state update, and q (q + 1) s for the triangle of C B^T once a
//   group: 54.04 GFLOP. The sequential recurrence needs 5 p s a position
//   and head: 53.69 GFLOP, the fewer, so 0.801 ms at 67 TFLOP/s fp32
//   (H100 SXM), against 349,176,448 bytes (0.104 ms at 3.35 TB/s): bound by
//   operations (chip_smoke.py _ssd_cost). This kernel recomputes C B^T for
//   every head, as the Pallas kernel does, and skips the products above the
//   causal diagonal in 32-row strips (the strip on the diagonal is whole).
//   Design: a simple kernel, right first. One block of 256 threads a (batch
//   row, head); each chunk's X, B, C go to shared memory as fp32, the state
//   lives in registers (a warp owns 8 rows of S, a thread 8 x 4 values)
//   with a copy in shared memory for the output products. The scores are
//   built 32 rows at a time (a 32 x q strip) and consumed at once by the
//   intra-chunk product, so the (q, q) matrix is never whole. The mask is
//   applied before the exp (above the diagonal seg > 0 could overflow and
//   inf * 0 is NaN). Every product reads shared memory 4 floats at a time
//   along its reduction (float4; the rows a warp shares are broadcasts),
//   the sums still running in order: B and S rows are 4 mod 8 floats apart
//   so that 8 lanes reading 8 rows hit distinct banks. At the path shape a
//   block takes 218,112 bytes of shared memory: one block an SM. Tensor
//   cores (mma on the bf16 tiles), sharing C B^T across a group's heads and
//   TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;               // score rows built at a time
constexpr int kRowsW = kStrip / kWarps;  // strip rows a warp
constexpr int kMaxQ = 128;               // chunk length
constexpr int kMaxP = 64;                // head dim
constexpr int kMaxS = 128;               // state dim
constexpr int kSU = kMaxP / kWarps;      // state rows a thread
constexpr int kSV = kMaxS / 32;          // state columns a thread
constexpr int kJT = kMaxQ / 32;          // score columns a lane
constexpr int kPU = kMaxP / 32;          // output columns a lane
constexpr int kMaxSmem = 232448;         // bytes a block may use (227 KB)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int round4(int v) {
  return (v + 3) / 4 * 4;
}

// Row strides (floats) of the shared tiles: X [q4][p4], B [q][sb],
// C [q][s4], S [p][sb], the score strip [kStrip][q4], with q4, p4, s4 the
// sizes rounded up to 4 (16-byte rows for float4 reads) and sb = s
// rounded up to 8, plus 4: rows 4 mod 8 floats apart, so 8 lanes reading
// a float4 each from 8 consecutive rows hit distinct banks.
struct Tiles {
  int q4, p4, s4, sb;
  __host__ __device__ Tiles(int q, int p, int s)
      : q4(round4(q)), p4(round4(p)), s4(round4(s)), sb((s + 7) / 8 * 8 + 4) {}
  // floats of a block's shared memory, with dt, cum, exp(cum) and the
  // state weights [q4] each
  __host__ __device__ long long floats(int q, int p) const {
    return (long long)q4 * p4 + (long long)q * sb + (long long)q * s4 +
           (long long)p * sb + (long long)kStrip * q4 + 4LL * q4;
  }
};

long long smem_floats(long long q, long long p, long long s) {
  return Tiles((int)q, (int)p, (int)s).floats((int)q, (int)p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc += a . (b.x, b.y, b.z, b.w) in order: four FMAs, as four steps of
// the scalar loop
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dsk,
                    T* __restrict__ y, int n, int h, int g, int p, int s,
                    int q) {
  extern __shared__ __align__(16) float smem[];
  const int hi = blockIdx.x;
  const long long bi = blockIdx.y;
  const int gi = hi / (h / g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tiles tl(q, p, s);
  const int q4 = tl.q4, p4 = tl.p4, s4 = tl.s4, sb = tl.sb;
  float* xs = smem;               // [q4][p4]
  float* bs = xs + q4 * p4;       // [q][sb]
  float* cs = bs + q * sb;        // [q][s4]
  float* ss = cs + q * s4;        // [p][sb]
  float* ps = ss + p * sb;        // [kStrip][q4]
  float* dts = ps + kStrip * q4;  // [q4]
  float* cum = dts + q4;
  float* ecum = cum + q4;
  float* wj = ecum + q4;
  const float av = a[hi], dv = dsk[hi];
  const long long xrow = (long long)h * p;   // x elements a position
  const long long brow = (long long)g * s;   // B, C elements a position
  const T* xb = x + bi * n * xrow + (long long)hi * p;
  const T* bb = bm + bi * n * brow + (long long)gi * s;
  const T* cb = cm + bi * n * brow + (long long)gi * s;
  const float* dtb = dt + bi * n * h + hi;
  T* yb = y + bi * n * xrow + (long long)hi * p;

  // S[c][k], c = kSU warp + u (8 consecutive rows a warp), k = lane + 32 v
  float st[kSU][kSV];
#pragma unroll
  for (int u = 0; u < kSU; ++u)
#pragma unroll
    for (int v = 0; v < kSV; ++v) st[u][v] = 0.f;
  // zero S with its padding once: only rows < p, columns < s are written
  for (int e = tid; e < p * sb; e += kThreads) ss[e] = 0.f;

  for (int t0 = 0; t0 < n; t0 += q) {
    const int nv = min(q, n - t0);        // valid rows of this chunk
    __syncthreads();                      // the last chunk's reads are done
    // tiles as fp32, zero past n and in the padding
    for (int e = tid; e < q4 * p4; e += kThreads) {
      const int j = e / p4, c = e - j * p4;
      xs[e] = j < nv && c < p ? to_f(xb[(long long)(t0 + j) * xrow + c])
                              : 0.f;
    }
    for (int e = tid; e < q * s4; e += kThreads) {
      const int j = e / s4, k = e - j * s4;
      const bool ok = j < nv && k < s;
      const long long off = (long long)(t0 + j) * brow + k;
      bs[j * sb + k] = ok ? to_f(bb[off]) : 0.f;
      cs[e] = ok ? to_f(cb[off]) : 0.f;
    }
    for (int j = tid; j < q4; j += kThreads)
      dts[j] = j < nv ? dtb[(long long)(t0 + j) * h] : 0.f;
    __syncthreads();
    if (tid == 0) {                       // in order, as torch.cumsum
      float acc = 0.f;
      for (int j = 0; j < q; ++j) {   // dt a rounded, then added: no FMA
        acc = __fadd_rn(acc, __fmul_rn(dts[j], av));
        cum[j] = acc;
      }
    }
    __syncthreads();
    const float clast = cum[q - 1];
    for (int j = tid; j < q; j += kThreads) {
      ecum[j] = expf(cum[j]);
      wj[j] = expf(clast - cum[j]) * dts[j];
    }
    __syncthreads();

    for (int i0 = 0; i0 < q; i0 += kStrip) {
      // scores of rows i0 .. i0+31: P[i][j] = (C_i . B_j) L[i][j] dt_j for
      // j < jend, the columns any of these rows reaches; columns up to
      // jend rounded to 4 are written (zeros past jend)
      const int jend = min(q, i0 + kStrip);
      const int jend4 = round4(jend);
      const int ntile = (jend4 + 31) / 32;
      {
        float acc[kRowsW][kJT];
#pragma unroll
        for (int r = 0; r < kRowsW; ++r)
#pragma unroll
          for (int t = 0; t < kJT; ++t) acc[r][t] = 0.f;
        const float* crow[kRowsW];
#pragma unroll
        for (int r = 0; r < kRowsW; ++r)
          crow[r] = cs + min(i0 + warp * kRowsW + r, q - 1) * s4;
        const float* brow_[kJT];
#pragma unroll
        for (int t = 0; t < kJT; ++t)
          brow_[t] = bs + min(lane + 32 * t, q - 1) * sb;
        for (int k = 0; k < s4; k += 4) {
          float4 cv[kRowsW];
#pragma unroll
          for (int r = 0; r < kRowsW; ++r) cv[r] = ld4(crow[r] + k);
#pragma unroll
          for (int t = 0; t < kJT; ++t) {
            if (t < ntile) {
              const float4 bv = ld4(brow_[t] + k);
#pragma unroll
              for (int r = 0; r < kRowsW; ++r)
                acc[r][t] = fma4(cv[r], bv, acc[r][t]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsW; ++r) {
          const int i = i0 + warp * kRowsW + r;
#pragma unroll
          for (int t = 0; t < kJT; ++t) {
            const int j = lane + 32 * t;
            if (t < ntile && i < q && j < jend4) {
              float v = 0.f;
              if (j <= i) v = acc[r][t] * expf(cum[i] - cum[j]) * dts[j];
              ps[(i - i0) * q4 + j] = v;
            }
          }
        }
      }
      __syncthreads();
      // outputs of rows i0 .. i0+31: the strip's scores times X, plus
      // exp(cum_i) C_i S^T, plus D x_i
      {
        float yi[kRowsW][kPU], yo[kRowsW][kPU];
#pragma unroll
        for (int r = 0; r < kRowsW; ++r)
#pragma unroll
          for (int u = 0; u < kPU; ++u) yi[r][u] = yo[r][u] = 0.f;
        int rl[kRowsW], cc[kPU];
#pragma unroll
        for (int r = 0; r < kRowsW; ++r)
          rl[r] = min(warp * kRowsW + r, q - 1 - i0);
#pragma unroll
        for (int u = 0; u < kPU; ++u) cc[u] = min(lane + 32 * u, p - 1);
        for (int j = 0; j < jend4; j += 4) {
          float4 pv[kRowsW];
#pragma unroll
          for (int r = 0; r < kRowsW; ++r) pv[r] = ld4(ps + rl[r] * q4 + j);
          float xv[4][kPU];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int u = 0; u < kPU; ++u) xv[jj][u] = xs[(j + jj) * p4 + cc[u]];
#pragma unroll
          for (int r = 0; r < kRowsW; ++r)
#pragma unroll
            for (int u = 0; u < kPU; ++u) {
              float acc = yi[r][u];
              acc = fmaf(pv[r].x, xv[0][u], acc);
              acc = fmaf(pv[r].y, xv[1][u], acc);
              acc = fmaf(pv[r].z, xv[2][u], acc);
              yi[r][u] = fmaf(pv[r].w, xv[3][u], acc);
            }
        }
        const float* crow[kRowsW];
#pragma unroll
        for (int r = 0; r < kRowsW; ++r) crow[r] = cs + (i0 + rl[r]) * s4;
        for (int k = 0; k < s4; k += 4) {
          float4 sv[kPU];
#pragma unroll
          for (int u = 0; u < kPU; ++u) sv[u] = ld4(ss + cc[u] * sb + k);
#pragma unroll
          for (int r = 0; r < kRowsW; ++r) {
            const float4 cv = ld4(crow[r] + k);
#pragma unroll
            for (int u = 0; u < kPU; ++u) yo[r][u] = fma4(cv, sv[u], yo[r][u]);
          }
        }
#pragma unroll
        for (int r = 0; r < kRowsW; ++r) {
          const int i = i0 + warp * kRowsW + r;
          if (i >= nv) continue;
#pragma unroll
          for (int u = 0; u < kPU; ++u) {
            const int c = lane + 32 * u;
            if (c < p)
              store(yb + (long long)(t0 + i) * xrow + c,
                    yi[r][u] + ecum[i] * yo[r][u] + dv * xs[i * p4 + c]);
          }
        }
      }
      __syncthreads();                    // before the next strip's scores
    }

    // S <- exp(cum_last) S + X^T (B . w): the state the next chunk reads.
    // A warp owns 8 consecutive rows of S, so its X reads are two float4
    // broadcasts a position.
    const float dl = expf(clast);
#pragma unroll
    for (int u = 0; u < kSU; ++u)
#pragma unroll
      for (int v = 0; v < kSV; ++v) st[u][v] *= dl;
    const int c0 = warp * kSU;
    if (c0 < p) {
      int sv[kSV];
#pragma unroll
      for (int v = 0; v < kSV; ++v) sv[v] = min(lane + 32 * v, s - 1);
      const bool hi4 = c0 + 4 < p4;       // the second float4 is in the row
      for (int j = 0; j < nv; ++j) {
        const float w = wj[j];
        float bv[kSV];
#pragma unroll
        for (int v = 0; v < kSV; ++v) bv[v] = bs[j * sb + sv[v]] * w;
        const float4 xa = ld4(xs + j * p4 + c0);
        const float4 xc = hi4 ? ld4(xs + j * p4 + c0 + 4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        const float xv[kSU] = {xa.x, xa.y, xa.z, xa.w,
                               xc.x, xc.y, xc.z, xc.w};
#pragma unroll
        for (int u = 0; u < kSU; ++u)
#pragma unroll
          for (int v = 0; v < kSV; ++v) st[u][v] = fmaf(xv[u], bv[v], st[u][v]);
      }
#pragma unroll
      for (int u = 0; u < kSU; ++u) {
        const int c = c0 + u;
#pragma unroll
        for (int v = 0; v < kSV; ++v) {
          const int k = lane + 32 * v;
          if (c < p && k < s) ss[c * sb + k] = st[u][v];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* dsk, void* y, long long bt, long long n,
           long long h, long long g, long long p, long long s, long long q,
           void* stream) {
  const long long smem = 4 * smem_floats(q, p, s);
  if (n < 1 || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || s < 1 ||
      s > kMaxS || g < 1 || h % g != 0 || smem > kMaxSmem || bt > 65535 ||
      h > 2147483647LL || n > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the dynamic shared memory this instance's attribute allows, per device
  // (the attribute is per device; 48 KB until raised)
  static long long smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = smem;
  }
  const dim3 grid((unsigned)h, (unsigned)bt);
  ssd_scan_kernel<T><<<grid, kThreads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(dsk),
      static_cast<T*>(y), (int)n, (int)h, (int)g, (int)p, (int)s, (int)q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest chunk, head dim and state dim the kernel takes.
long long ssd_scan_max_q() { return kMaxQ; }
long long ssd_scan_max_p() { return kMaxP; }
long long ssd_scan_max_s() { return kMaxS; }

// x, y: (bt, n, h, p); dt: (bt, n, h); a, dsk: (h,); b, c: (bt, n, g, s);
// contiguous on the device, x, b, c, y fp32 (_f32) or bf16 (_bf16), the rest
// fp32; 1 <= q <= 128, p <= 64, s <= 128, g divides h. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take.
int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, const void* dsk, void* y, long long bt,
                 long long n, long long h, long long g, long long p,
                 long long s, long long q, void* stream) {
  return launch<float>(x, dt, a, b, c, dsk, y, bt, n, h, g, p, s, q, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                  const void* c, const void* dsk, void* y, long long bt,
                  long long n, long long h, long long g, long long p,
                  long long s, long long q, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, b, c, dsk, y, bt, n, h, g, p, s, q,
                               stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
