// Hand-written Hopper (sm_90a) kernels of the Mamba-2 SSD chunked scan,
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
//   reads group i / (h/g). The TPU kernel moves (b, h) to the front with
//   moveaxis copies, repeats B and C to every head, runs the chunk axis as
//   a sequential grid dimension and asserts n % q == 0. Here a block of 256
//   threads takes one (batch row, head), reads x, dt, B and C in place from
//   their (b, n, h, .) and (b, n, g, .) layouts, loops over the chunks
//   itself and masks a ragged last chunk (rows past n read as zero, dt = 0
//   there: no decay and no input), which is the plain version's zero
//   padding. Every n >= 1, q <= 128, p <= 64, s <= 128 and g | h runs here:
//   no fallback, and each dtype has one body.
//
// The bf16 instance (ssd_scan_bf16_kernel) runs its products on the tensor
//   cores with mma.sync and fp32 accumulators:
//   - C B^T: m16n8k16 bf16 x bf16, exact products summed in fp32 (both
//     operands are the bf16 inputs), in four accumulator chains;
//   - scores . X, C S^T and (X . w)^T B: m16n8k8 TF32. The fp32 operand of
//     each (the scores (C B^T) L dt, the carried state S, and X . w with
//     w_j = exp(cum_last - cum_j) dt_j) is rounded to TF32: to nearest,
//     ties away from zero (cvt.rna's rounding, done as an integer add and
//     mask, which ran faster here than the cvt). The bf16 operand is exact
//     in TF32. A TF32 k-step takes its 8 positions in the order (2t, 2t+1
//     -> slots t, t+4), so a C-fragment of fp32 scores is an A operand in
//     registers and a bf16 pair from ldmatrix(.trans) is the B operand's
//     two values;
//   - S stays fp32 across chunks in the accumulator fragments of the warp
//     that updates it (warp w: rows 16 (w % 4) .., columns 64 (w / 4) ..);
//     shared memory holds its TF32 copy, rounded once when written, which
//     C S^T reads. The exponentials are ex2.approx.ftz (2^-22 relative).
//     The cumsum is a warp-shuffle scan that every warp runs on its own.
//   Error budget (tests/test_torch_ssd_scan.py emulates these roundings in
//   plain torch and holds them under 2e-3 x max|y| of float64 ref before
//   y's rounding to bf16); after it the kernel and the plain version
//   differ by at most one bf16 ulp of an element (2^-7 x max at worst)
//   plus that: under BF16_TOL = 1e-2 x max, which chip_smoke.py holds it
//   to.
//   Layout: X [128][64], B and C [128][128] bf16 in shared memory, rows of
//   16-byte chunks XOR-swizzled by row & 7 (ldmatrix reads 8 rows of one
//   chunk without bank conflicts), loaded by 16-byte cp.async with zero
//   fill past n, p and s (a shape whose rows are not 16-byte multiples
//   loads element by element into the same tiles); S's TF32 copy [64][128]
//   with each 16 columns in the order the C S^T fragment reads them (one
//   16-byte read a thread a k16 step), swizzled by row & 1. 115,712 bytes
//   a block: two blocks (16 warps) an SM. Tiles are padded with zeros to
//   q = 128, p = 64, s = 128 and every product covers the padded tile: a
//   guard a k-step became a branch that kept the compiler from overlapping
//   one step's loads with the last one's products. Warp w owns rows
//   16w .. 16w + 15 of y: C S^T, then the scores of column blocks 0 .. w,
//   16 columns at a time (C B^T into registers, masked before the exp,
//   decayed, rounded, and at once the A operand of scores . X), so the
//   (q, q) scores are never stored. Three barriers a chunk; the next
//   chunk's C is in flight during the state update, its X, B and dt load
//   after it (the SM's other block computes meanwhile).
//   Bound at the Mamba2-2.7B path shape (x (8, 2048, 80, 64) bf16, B and C
//   (8, 2048, 1, 128), q = 128): the chunked form's 53.77 GFLOP in TF32
//   (the lower triangle of scores . X, C S^T and the state update) over
//   the 495 TFLOP/s dense TF32 peak, plus the 0.27 GFLOP of C B^T's lower
//   triangle, once a group, over the 989 TFLOP/s bf16 peak (H100 SXM):
//   0.109 ms, against 349,176,448 bytes (0.104 ms at 3.35 TB/s)
//   (chip_smoke.py _ssd_cost). The kernel issues 3,200 mma a block and
//   chunk (C B^T again for every head, whole 16 x 16 blocks on the
//   diagonal): 79 GFLOP. What limits it (tools/ssd_scan_phases.py times
//   each phase of a chunk; a "// phase:" comment ends each): the
//   diagonal, whose 8 column blocks make warp 7 the chunk's critical path
//   (warp 0 has 1); mma.sync's rate rather than wgmma's; 128 registers a
//   thread (two blocks an SM) with a few spills; and 640 blocks over 264
//   block slots (2.4 waves).
//
// The fp32 instance (ssd_scan_f32_kernel) keeps v2's arithmetic: fp32
//   FMAs on the CUDA cores, the cumsum in order on one thread (as
//   torch.cumsum), X, B, C as fp32 tiles, every product reading shared
//   memory 4 floats at a time along its reduction, the scores built 32
//   rows at a time, the state in registers with a shared copy: 218,112
//   bytes, one block an SM. Its bound is the sequential recurrence's
//   53.69 GFLOP over 67 TFLOP/s fp32: 0.801 ms (operations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;               // chunk length
constexpr int kMaxP = 64;                // head dim
constexpr int kMaxS = 128;               // state dim
constexpr int kMaxSmem = 232448;         // bytes a block may use (227 KB)
constexpr int kMaxDevices = 64;

// ------------------------------------------------------- fp32 instance
constexpr int kStrip = 32;               // score rows built at a time
constexpr int kRowsW = kStrip / kWarps;  // strip rows a warp
constexpr int kSU = kMaxP / kWarps;      // state rows a thread
constexpr int kSV = kMaxS / 32;          // state columns a thread
constexpr int kJT = kMaxQ / 32;          // score columns a lane
constexpr int kPU = kMaxP / 32;          // output columns a lane

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

__global__ void __launch_bounds__(kThreads, 1)
    ssd_scan_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ dsk, float* __restrict__ y,
                        int n, int h, int g, int p, int s, int q) {
  extern __shared__ __align__(16) float smem_f[];
  const int hi = blockIdx.x;
  const long long bi = blockIdx.y;
  const int gi = hi / (h / g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tiles tl(q, p, s);
  const int q4 = tl.q4, p4 = tl.p4, s4 = tl.s4, sb = tl.sb;
  float* xs = smem_f;             // [q4][p4]
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
  const float* xb = x + bi * n * xrow + (long long)hi * p;
  const float* bb = bm + bi * n * brow + (long long)gi * s;
  const float* cb = cm + bi * n * brow + (long long)gi * s;
  const float* dtb = dt + bi * n * h + hi;
  float* yb = y + bi * n * xrow + (long long)hi * p;

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
    // tiles, zero past n and in the padding
    for (int e = tid; e < q4 * p4; e += kThreads) {
      const int j = e / p4, c = e - j * p4;
      xs[e] = j < nv && c < p ? xb[(long long)(t0 + j) * xrow + c] : 0.f;
    }
    for (int e = tid; e < q * s4; e += kThreads) {
      const int j = e / s4, k = e - j * s4;
      const bool ok = j < nv && k < s;
      const long long off = (long long)(t0 + j) * brow + k;
      bs[j * sb + k] = ok ? bb[off] : 0.f;
      cs[e] = ok ? cb[off] : 0.f;
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
              yb[(long long)(t0 + i) * xrow + c] =
                  yi[r][u] + ecum[i] * yo[r][u] + dv * xs[i * p4 + c];
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

// ------------------------------------------------------- bf16 instance
using bf16 = __nv_bfloat16;

// shared memory of a block (bytes): the bf16 tiles, S's TF32 copy, cum,
// and dt (w from the state update on)
constexpr int kXRow = kMaxP * 2;                 // 128-byte X rows
constexpr int kBRow = kMaxS * 2;                 // 256-byte B, C rows
constexpr int kOffB = kMaxQ * kXRow;             // X at 0
constexpr int kOffC = kOffB + kMaxQ * kBRow;
constexpr int kOffS = kOffC + kMaxQ * kBRow;
constexpr int kOffCum = kOffS + kMaxP * kMaxS * 4;
constexpr int kOffDt = kOffCum + kMaxQ * 4;
constexpr int kTcSmem = kOffDt + kMaxQ * 4;      // 115,712
static_assert(kTcSmem == 115712, "two blocks an SM: 2 (smem + 1 KB) <= 228 KB");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory, zero-filled past `bytes` (0 or 16)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  mma_tf32(d, a[0], a[1], a[2], a[3], b0, b1);
}

// fp32 rounded to TF32 as the operand's bits: to nearest, ties away from
// zero (cvt.rna.tf32.f32's rounding), by two integer operations
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// e^v by ex2.approx.ftz (2^-22 relative; 0 for v = -inf, and flushed to 0
// below 2^-126)
__device__ __forceinline__ float exp_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v * 1.44269504f));
  return r;
}

// the two bf16 of a packed pair as fp32 bits (exact, so TF32 as they are):
// the lower address (the lower column, or with .trans the lower row)
__device__ __forceinline__ uint32_t lo_b(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t hi_b(uint32_t v) {
  return v & 0xffff0000u;
}
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(lo_b(v));
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(hi_b(v));
}

// byte offset of 16-byte chunk ck of row r in a tile of `row` bytes a row
__device__ __forceinline__ uint32_t tile_off(int r, int ck, int row) {
  return r * row + ((ck ^ (r & 7)) << 4);
}

// float offset of the 4 floats thread t of a quad reads in row `r`, group
// `grp` (columns 16 grp .. 16 grp + 15) of S: the group stores columns
// (2t, 2t+1, 2t+8, 2t+9) at 4t .. 4t+3, and odd rows swap neighbouring
// groups (16 bytes apart by 64) so that rows r, r+1 hit distinct banks
__device__ __forceinline__ int s_off(int r, int grp, int t) {
  return r * kMaxS + ((grp ^ (r & 1)) << 4) + (t << 2);
}

// rows 0 .. 127 of a bf16 tile of kCk 16-byte chunks a row: row r < nv
// copies `cols` elements from src + r * stride, the rest is zero. `vec`:
// cols % 8 == 0 and 16-byte aligned rows, copied by cp.async (a thread
// keeps one chunk column, so its swizzle and source step are fixed);
// otherwise element by element.
template <int kCk>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const bf16* src, long long stride,
                                          int nv, int cols, bool vec,
                                          int tid) {
  constexpr int kRow = kCk * 16, kRows = kThreads / kCk;
  if (vec) {
    const int ck = tid % kCk, r0 = tid / kCk;
    const bool col_ok = ck < (cols >> 3);
    const uint32_t dst = smem_u32(tile) + tile_off(r0, ck, kRow);
    const bf16* sp = src + r0 * stride + ck * 8;
#pragma unroll
    for (int it = 0; it < kMaxQ / kRows; ++it) {
      const bool ok = col_ok && r0 + it * kRows < nv;
      cp_async16(dst + it * kRows * kRow, ok ? sp + it * kRows * stride : src,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int w = kCk * 8;
    for (int e = tid; e < kMaxQ * w; e += kThreads) {
      const int r = e / w, c = e - r * w;
      const bf16 v = r < nv && c < cols ? src[r * stride + c]
                                        : __float2bfloat16_rn(0.f);
      *reinterpret_cast<bf16*>(tile + tile_off(r, c >> 3, kRow) +
                               (c & 7) * 2) = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_bf16_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const bf16* __restrict__ bm,
                         const bf16* __restrict__ cm,
                         const float* __restrict__ dsk, bf16* __restrict__ y,
                         int n, int h, int g, int p, int s, int q, int vec) {
  extern __shared__ __align__(128) unsigned char smem_b[];
  unsigned char* xt = smem_b;
  unsigned char* bt_ = smem_b + kOffB;
  unsigned char* ct = smem_b + kOffC;
  float* ss = reinterpret_cast<float*>(smem_b + kOffS);
  float* cum = reinterpret_cast<float*>(smem_b + kOffCum);
  float* dts = reinterpret_cast<float*>(smem_b + kOffDt);
  const uint32_t xs = smem_u32(xt), bs = smem_u32(bt_), cs = smem_u32(ct);
  const uint32_t dts_u = smem_u32(dts);
  const int hi = blockIdx.x;
  const long long bi = blockIdx.y;
  const int gi = hi / (h / g);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma group and thread in it
  const float av = a[hi], dv = dsk[hi];
  const long long xrow = (long long)h * p;   // x elements a position
  const long long brow = (long long)g * s;   // B, C elements a position
  const bf16* xb = x + bi * n * xrow + (long long)hi * p;
  const bf16* bb = bm + bi * n * brow + (long long)gi * s;
  const bf16* cb = cm + bi * n * brow + (long long)gi * s;
  const float* dtb = dt + bi * n * h + hi;
  bf16* yb = y + bi * n * xrow + (long long)hi * p;

  auto load_c = [&](int t0) {
    load_tile<kBRow / 16>(ct, cb + t0 * brow, brow, min(q, n - t0), s, vec,
                          tid);
  };
  auto load_xbd = [&](int t0) {
    const int nv = min(q, n - t0);
    load_tile<kXRow / 16>(xt, xb + t0 * xrow, xrow, nv, p, vec, tid);
    load_tile<kBRow / 16>(bt_, bb + t0 * brow, brow, nv, s, vec, tid);
    if (tid < kMaxQ) {
      const bool ok = tid < nv;
      cp_async4(dts_u + 4 * tid, ok ? dtb + (long long)(t0 + tid) * h : dtb,
                ok ? 4 : 0);
    }
  };

  // S's fp32 values live in the accumulator fragments of the warp that
  // updates them, rows 16 mt .. 16 mt + 15, columns 64 nh .. 64 nh + 63;
  // shared memory holds their TF32 copy, the operand of C S^T
  const int mt = warp & 3, nh = warp >> 2;
  const bool owns = 16 * mt < p && 64 * nh < s;
  float st[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[i][e] = 0.f;
  for (int e = tid; e < kMaxP * kMaxS; e += kThreads) ss[e] = 0.f;
  load_c(0);
  load_xbd(0);
  cp_async_commit();

  // phase: start
  for (int t0 = 0; t0 < n; t0 += q) {
    const int nv = min(q, n - t0);        // valid rows of this chunk
    cp_async_wait_all();
    __syncthreads();                      // the chunk's tiles have landed
    // phase: wait

    // cum: every warp scans the 128 positions (4 a lane) and writes the
    // same values; w_j = exp(cum_last - cum_j) dt_j waits in registers
    const float4 d4 = *reinterpret_cast<const float4*>(dts + 4 * lane);
    float c0 = __fmul_rn(d4.x, av);       // dt a rounded, then added
    float c1 = __fadd_rn(c0, __fmul_rn(d4.y, av));
    float c2 = __fadd_rn(c1, __fmul_rn(d4.z, av));
    float c3 = __fadd_rn(c2, __fmul_rn(d4.w, av));
    float incl = c3;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, v);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    c0 = __fadd_rn(excl, c0);
    c1 = __fadd_rn(excl, c1);
    c2 = __fadd_rn(excl, c2);
    c3 = __fadd_rn(excl, c3);
    const float clast = __shfl_sync(0xffffffffu, c3, 31);
    *reinterpret_cast<float4*>(cum + 4 * lane) = make_float4(c0, c1, c2, c3);
    const float4 w4 = make_float4(
        exp_ftz(clast - c0) * d4.x, exp_ftz(clast - c1) * d4.y,
        exp_ftz(clast - c2) * d4.z, exp_ftz(clast - c3) * d4.w);
    __syncwarp();
    // phase: cumsum

    // y of rows 16 warp .. 16 warp + 15; C's rows are read as bf16 A
    // fragments, k16 step ks, where a product needs them
    if (16 * warp < q) {
      const int rc = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int i0 = 16 * warp + gq, i1 = i0 + 8;
      const float ci0 = cum[i0], ci1 = cum[i1];
      float yacc[kMaxP / 8][4];
#pragma unroll
      for (int on = 0; on < kMaxP / 8; ++on)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[on][e] = 0.f;

      // C S^T: the k16 step's two TF32 halves read S columns (2t, 2t+1)
      // and (2t+8, 2t+9), stored together, already rounded
#pragma unroll
      for (int ks = 0; ks < kMaxS / 16; ++ks) {
        uint32_t cf[4];
        ldsm4(cf, cs + tile_off(rc, 2 * ks + (lane >> 4), kBRow));
#pragma unroll
        for (int on = 0; on < kMaxP / 8; ++on) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              ss + s_off(8 * on + gq, ks, tq));
          mma_tf32(yacc[on], lo_b(cf[0]), lo_b(cf[1]), hi_b(cf[0]),
                   hi_b(cf[1]), v.x, v.y);
          mma_tf32(yacc[on], lo_b(cf[2]), lo_b(cf[3]), hi_b(cf[2]),
                   hi_b(cf[3]), v.z, v.w);
        }
      }
      const float e0 = exp_ftz(ci0), e1 = exp_ftz(ci1);
#pragma unroll
      for (int on = 0; on < kMaxP / 8; ++on) {
        yacc[on][0] *= e0;
        yacc[on][1] *= e0;
        yacc[on][2] *= e1;
        yacc[on][3] *= e1;
      }
      // phase: CS^T

      // the scores 16 columns at a time, each block at once times X
      for (int c = 0; c <= warp; ++c) {
        // even and odd k16 steps in separate accumulators (four
        // independent chains), added at the end
        float sc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < kMaxS / 16; ++ks) {
          uint32_t cf[4], bf[4];
          const int r = 16 * c + (lane & 7) + (lane >> 4) * 8;
          ldsm4(cf, cs + tile_off(rc, 2 * ks + (lane >> 4), kBRow));
          ldsm4(bf, bs + tile_off(r, 2 * ks + ((lane >> 3) & 1), kBRow));
          mma_bf16(sc[2 * (ks & 1)], cf, bf[0], bf[1]);
          mma_bf16(sc[2 * (ks & 1) + 1], cf, bf[2], bf[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nt][e] += sc[nt + 2][e];
        // P[i][j] = (C B^T)[i][j] L[i][j] dt_j, masked before the exp,
        // rounded to TF32: the k8 step nt's A operand, slots (t, t+4) =
        // columns (2t, 2t+1)
        uint32_t pa[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 16 * c + 8 * nt + 2 * tq;
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          const float ninf = __int_as_float(0xff800000);  // -inf
          const float p00 =
              sc[nt][0] * exp_ftz(j <= i0 ? ci0 - cj.x : ninf) * dj.x;
          const float p01 =
              sc[nt][1] * exp_ftz(j + 1 <= i0 ? ci0 - cj.y : ninf) * dj.y;
          const float p10 =
              sc[nt][2] * exp_ftz(j <= i1 ? ci1 - cj.x : ninf) * dj.x;
          const float p11 =
              sc[nt][3] * exp_ftz(j + 1 <= i1 ? ci1 - cj.y : ninf) * dj.y;
          pa[nt][0] = tf32(p00);
          pa[nt][1] = tf32(p10);
          pa[nt][2] = tf32(p01);
          pa[nt][3] = tf32(p11);
        }
#pragma unroll
        for (int op = 0; op < kMaxP / 16; ++op) {
          uint32_t xf[4];
          const int r = 16 * c + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm4_t(xf, xs + tile_off(r, 2 * op + (lane >> 4), kXRow));
          mma_tf32(yacc[2 * op], pa[0], lo_b(xf[0]), hi_b(xf[0]));
          mma_tf32(yacc[2 * op], pa[1], lo_b(xf[1]), hi_b(xf[1]));
          mma_tf32(yacc[2 * op + 1], pa[0], lo_b(xf[2]), hi_b(xf[2]));
          mma_tf32(yacc[2 * op + 1], pa[1], lo_b(xf[3]), hi_b(xf[3]));
        }
      }
      // phase: scores

      // y = scores X + exp(cum_i) C S^T + D x, rows < nv, columns < p
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        if (i >= nv) continue;
        bf16* yrow = yb + (long long)(t0 + i) * xrow;
#pragma unroll
        for (int on = 0; on < kMaxP / 8; ++on) {
          if (8 * on >= p) continue;          // the same for the warp
          const int col = 8 * on + 2 * tq;
          const uint32_t xv = *reinterpret_cast<const uint32_t*>(
              xt + tile_off(i, on, kXRow) + 4 * tq);
          const float y0 = yacc[on][2 * half] + dv * lo_f(xv);
          const float y1 = yacc[on][2 * half + 1] + dv * hi_f(xv);
          if (vec) {
            *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                __floats2bfloat162_rn(y0, y1);
          } else if (col < p) {
            yrow[col] = __float2bfloat16_rn(y0);
            if (col + 1 < p) yrow[col + 1] = __float2bfloat16_rn(y1);
          }
        }
      }
    }
    // phase: y
    __syncthreads();                      // S and C are read
    // phase: barrier 2
    const bool more = t0 + q < n;
    if (more) {
      load_c(t0 + q);                     // lands during the state update
      cp_async_commit();
    }
    // dt's slots take w (every warp writes the same values; dt is read)
    *reinterpret_cast<float4*>(dts + 4 * lane) = w4;
    __syncwarp();

    // S <- exp(cum_last) S + (X . w)^T B on this warp's tile, then its
    // TF32 copy to shared memory
    if (owns) {
      const float dl = exp_ftz(clast);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] *= dl;
#pragma unroll
      for (int kp = 0; kp < kMaxQ / 16; ++kp) {
        const float2 wa = *reinterpret_cast<const float2*>(
            dts + 16 * kp + 2 * tq);
        const float2 wb = *reinterpret_cast<const float2*>(
            dts + 16 * kp + 8 + 2 * tq);
        uint32_t xf[4];
        {
          const int r = 16 * kp + (lane & 7) + (lane >> 4) * 8;
          ldsm4_t(xf, xs + tile_off(r, 2 * mt + ((lane >> 3) & 1), kXRow));
        }
        // A = (X . w)^T, k8 steps 16 kp and 16 kp + 8
        const uint32_t a0[4] = {tf32(lo_f(xf[0]) * wa.x),
                                tf32(lo_f(xf[1]) * wa.x),
                                tf32(hi_f(xf[0]) * wa.y),
                                tf32(hi_f(xf[1]) * wa.y)};
        const uint32_t a1[4] = {tf32(lo_f(xf[2]) * wb.x),
                                tf32(lo_f(xf[3]) * wb.x),
                                tf32(hi_f(xf[2]) * wb.y),
                                tf32(hi_f(xf[3]) * wb.y)};
#pragma unroll
        for (int ip = 0; ip < 4; ++ip) {
          uint32_t bf[4];
          const int r = 16 * kp + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm4_t(bf, bs + tile_off(r, 8 * nh + 2 * ip + (lane >> 4),
                                    kBRow));
          mma_tf32(st[2 * ip], a0, lo_b(bf[0]), hi_b(bf[0]));
          mma_tf32(st[2 * ip], a1, lo_b(bf[1]), hi_b(bf[1]));
          mma_tf32(st[2 * ip + 1], a0, lo_b(bf[2]), hi_b(bf[2]));
          mma_tf32(st[2 * ip + 1], a1, lo_b(bf[3]), hi_b(bf[3]));
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<uint2*>(
              ss + s_off(16 * mt + gq + 8 * half, 4 * nh + (i >> 1), tq) +
              2 * (i & 1)) =
              make_uint2(tf32(st[i][2 * half]), tf32(st[i][2 * half + 1]));
    }
    // phase: state
    __syncthreads();                      // X, B and w are read
    // phase: barrier 3
    if (more) {
      load_xbd(t0 + q);
      cp_async_commit();
    }
    // phase: loads
  }
  // phase: end
}

// ------------------------------------------------------------ launchers
bool bad_shape(long long bt, long long n, long long h, long long g,
               long long p, long long s, long long q) {
  return n < 1 || q < 1 || q > kMaxQ || p < 1 || p > kMaxP || s < 1 ||
         s > kMaxS || g < 1 || h % g != 0 || bt > 65535 ||
         h > 2147483647LL || n > 2147483647LL;
}

// raise kernel's dynamic shared memory limit to `smem` on the current
// device, once a device (the attribute is per device; 48 KB until raised)
int allow_smem(const void* kernel, long long smem, long long* smem_set,
               bool max_shared) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess && max_shared)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = smem;
  }
  return 0;
}

long long g_f32_smem[kMaxDevices] = {};
long long g_bf16_smem[kMaxDevices] = {};

int launch_f32(const void* x, const void* dt, const void* a, const void* b,
               const void* c, const void* dsk, void* y, long long bt,
               long long n, long long h, long long g, long long p,
               long long s, long long q, void* stream) {
  const long long smem = 4 * smem_floats(q, p, s);
  if (bad_shape(bt, n, h, g, p, s, q) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const int rc = allow_smem(reinterpret_cast<const void*>(
                                  ssd_scan_f32_kernel),
                              smem, g_f32_smem, false);
    if (rc) return rc;
  }
  const dim3 grid((unsigned)h, (unsigned)bt);
  ssd_scan_f32_kernel<<<grid, kThreads, (size_t)smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(dsk),
      static_cast<float*>(y), (int)n, (int)h, (int)g, (int)p, (int)s, (int)q);
  return static_cast<int>(cudaGetLastError());
}

int prepare_bf16() {
  return allow_smem(reinterpret_cast<const void*>(ssd_scan_bf16_kernel),
                    kTcSmem, g_bf16_smem, true);
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int launch_bf16(const void* x, const void* dt, const void* a, const void* b,
                const void* c, const void* dsk, void* y, long long bt,
                long long n, long long h, long long g, long long p,
                long long s, long long q, void* stream) {
  if (bad_shape(bt, n, h, g, p, s, q))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = prepare_bf16();
  if (rc) return rc;
  // 16-byte rows for cp.async and 4-byte pairs for the stores
  const int vec = p % 8 == 0 && s % 8 == 0 && aligned(x, 16) &&
                  aligned(b, 16) && aligned(c, 16) && aligned(y, 4);
  const dim3 grid((unsigned)h, (unsigned)bt);
  ssd_scan_bf16_kernel<<<grid, kThreads, (size_t)kTcSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<const float*>(dsk),
      static_cast<bf16*>(y), (int)n, (int)h, (int)g, (int)p, (int)s, (int)q,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest chunk, head dim and state dim the kernels take.
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
  return launch_f32(x, dt, a, b, c, dsk, y, bt, n, h, g, p, s, q, stream);
}

int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                  const void* c, const void* dsk, void* y, long long bt,
                  long long n, long long h, long long g, long long p,
                  long long s, long long q, void* stream) {
  return launch_bf16(x, dt, a, b, c, dsk, y, bt, n, h, g, p, s, q, stream);
}

// Blocks of the bf16 kernel an SM holds on the current device (its
// shared-memory attribute raised first), or minus a CUDA error.
int ssd_scan_bf16_blocks_per_sm() {
  int rc = prepare_bf16();
  if (rc) return -rc;
  int nb = 0;
  rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, ssd_scan_bf16_kernel, kThreads, kTcSmem));
  return rc ? -rc : nb;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
