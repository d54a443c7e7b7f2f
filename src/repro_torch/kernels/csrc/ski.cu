// Hand-written Hopper (sm_90a) kernels of the SKI-TNO forward (paper §3.2,
// Algorithm 1): y = W (A (W^T x)) + T_sparse x, fused (interp_reduce, then
// ski_fused_pass2 with a dense Gram, or at large rank ski_windowed_pass2 /
// ski_expand_pass2 with the Gram in Toeplitz-coefficient form) or unfused
// (interp_reduce, the Gram by FFT outside the kernels, interp_expand; the
// short conv in csrc/short_conv.cu), bound to PyTorch through a plain C
// interface (ctypes) by src/repro_torch/kernels/interp_matvec.py and
// ski_fused.py. x, y are (b, n, d) fp32, z = W^T x is (b, r, d), A is the
// (d, r, r) per-channel inducing Gram or its (d, 2r-1) Toeplitz
// coefficients and f the (d, m) short-conv taps, all contiguous.
//
// W is the linear interpolation onto r uniform inducing points with spacing
// h = (n-1)/(r-1): row i has two taps, w_lo on node lo = floor(i/h) and
// 1 - w_lo on lo + 1, with lo clamped to [0, r-2] and w_lo = 1 - (i/h - lo)
// clamped to [0, 1]. The kernels regenerate it from (n, r) in fp32 exactly
// as make_inducing (src/repro/core/ski.py) builds it: f = float(i) / hf with
// hf = float32(h) (IEEE division, no fast math), so no weight is read and
// the weights equal the plain version's bit for bit. (The Pallas kernels'
// unclamped hat max(0, 1 - |i/h - j|) is the same function except at the
// last row, where fp32 can put i/h a few ulp past r-1 and the hat gives
// 1 - 4e-6 where the clamp gives the reference's 1.)

// interp_reduce  replaces src/repro/kernels/interp_matvec.py _reduce_kernel /
//   _reduce_call (interp_reduce_pallas): z[b, j, c] = sum_i W[i, j] x[b, i, c].
//   The TPU kernel contracts a dense (bn, r) hat block on the MXU and carries
//   the sum over a sequential grid axis. Here each output gathers the only
//   positions that can weigh on node j, |i/h - j| < 1, about 2h + 1 of them
//   (widened by one on each side for fp32 rounding; a position whose two
//   taps miss j adds 0), in increasing i: no atomics and a fixed order, so
//   the result is bitwise the same from run to run.
//   Bound: x read once and z written once, 4 (b n d + b r d) bytes; the
//   2 b d (2n-2) flops of W's non-zeros are negligible. At (8, 512, 512),
//   r = 64: 9,437,184 bytes, 2.82 us at 3.35 TB/s (H100 SXM).
//   Design: one thread per (b, j, c), threads along c, so every load of an
//   x row is coalesced; neighbouring j re-read a row from L2 (each x element
//   is read about twice, once from device memory). The block's threads
//   compute W[i, j] for its rows once into shared memory (128 at a time), so
//   the fp32 division runs once per row and block, not once per thread: a
//   first version that divided in every thread took 13.9 us on an H100,
//   bound by instruction issue.
//
// interp_expand  replaces src/repro/kernels/interp_matvec.py _expand_kernel /
//   _expand_call (interp_expand_pallas): y[b, i, c] = sum_j W[i, j] z[b, j, c],
//   the adjoint of interp_reduce and the unfused SKI pipeline's last step.
//   The TPU kernel contracts a dense (bn, r) hat block with the whole z on
//   the MXU. Here row i reads only its two nodes: y = w_lo z[lo] +
//   (1 - w_lo) z[lo + 1], with (lo, w_lo) from hat_row, the same weights as
//   interp_reduce's bit for bit, so the two stay exact adjoints (the TPU
//   kernels' unclamped hat differs at the last row, see above).
//   Bound: z read once and y written once, 4 (b r d + b n d) bytes; 3 flops
//   an output. At (8, 512, 512), r = 64: 9,437,184 bytes, 2.82 us at
//   3.35 TB/s (H100 SXM): bound by bytes, nine tenths of it the write of y.
//   Design: a block owns 8 rows of one batch row; its first threads compute
//   the 8 rows' (lo, w_lo) into shared memory (one division a row), then the
//   256 threads sweep the rows' channels, 4 at a time with 16-byte loads and
//   stores when d % 4 == 0 (z and y 16-byte aligned), else one at a time.
//   z (1 MB at the path shape) stays in L2 for the neighbouring rows that
//   re-read its nodes. Every n >= 2 and 2 <= r <= n, r = n and r = 2
//   included, runs here: no fallback.
//
// ski_fused_pass2  replaces src/repro/kernels/ski_fused.py _fused_kernel /
//   _fused_call (ski_fused_pass2_pallas):
//     y[b, i, c] = sum_s W[i, s] z2[b, s, c] + sum_{k<m} f[c, k] x[b, i-k+left, c],
//     z2[b, s, c] = sum_t A[c, s, t] z[b, t, c],
//   x zero outside [0, n), one write of y. left is a runtime argument: the
//   forward uses 0 (causal) or m/2; the signal backward of a later slice is
//   this same kernel with A transposed, the taps flipped and left mirrored.
//   Bound: x, z, A, f read once and y written once: at (8, 512, 512), r = 64,
//   m = 32, 26,279,936 bytes, 7.84 us at 3.35 TB/s; 176 MFLOP (conv 134 M,
//   Gram 34 M, expand 8 M), 2.6 us at 67 TFLOP/s fp32: bound by bytes.
//   Design: one block per 8 batch rows x 4 channels (fewer rows and more
//   channels for a batch under 8), its 32 (row, channel) columns on a warp's
//   lanes, 8 warps.
//   1. The block's first x tiles are requested with cp.async, so they
//      stream in while 2 and 3 run.
//   2. z of the 32 columns is staged in shared memory transposed ([col][t],
//      pitch a multiple of 4 for 16-byte reads) and the taps as [k][col].
//   3. z2 = A z runs in the block, into shared memory (r x 33 floats): a
//      thread takes one row of one channel's A (16-byte loads), reads it
//      once and applies it to the block's 8 batch rows, summing t in order
//      (no atomics, no cross-lane sums). So A is read once per 8 batch rows,
//      8 MB in all at the scoring shape.
//   4. The sequence is cut into tiles of 128 rows, and the tiles are split
//      over blocks until about 3 blocks a SM run (at the scoring shape 2
//      blocks share a column group, two tiles each; each block computes
//      step 3 for its own columns). A block's tiles, plus the conv halo,
//      stream through a ring of up to 4 buffers (as many as 3 blocks a SM
//      leave room for) with cp.async (16-byte copies of 4 channels when
//      d % 4 == 0; zero-filled outside [0, n) and past b and d). W's 128
//      rows of a tile are computed once into shared memory. Each thread
//      owns one column and 16 consecutive rows; the conv
//      runs 8 taps at a time from a 23-row register window (taps padded with
//      zeros to a multiple of 8), so each x value leaves shared memory once
//      per 8 taps; then the two-tap expansion from z2 and one store. Every
//      n >= 2 and 2 <= r <= n runs here, n < m and r = n included: no
//      fallback to a plain version.
//   Earlier versions, at the scoring shape on an H100 (chip_smoke.py): one
//   block per (batch row, 32 channels), A read 8 times with a shuffle sum per
//   row of A, 92.7 us; A read once per 8 batch rows, 39.2 us; the conv from
//   a register window, 32.4 us. A block's phases (Gram, tile copies, conv,
//   stores) still run one after another with little overlap: warp
//   specialisation (a producer warp for the copies) is the next step.
//
// ski_windowed_pass2  replaces src/repro/kernels/ski_fused.py _windowed_kernel /
//   _windowed_call with banded=True (ski_windowed_pass2_pallas): the large-rank
//   pass 2 with the Gram given as its (d, 2r-1) Toeplitz coefficients,
//   A[c, s, t] = coef[c, s - t + r - 1]:
//     y[b, i, c] = sum_s W[i, s] z2[b, s, c] + sum_{k<m} f[c, k] x[b, i-k+left, c],
//     z2[b, s, c] = sum_t coef[c, s - t + r - 1] z[b, t, c],
//   one write of y. The TPU kernel streams kb = rp/bw Toeplitz (bw, bw) band
//   blocks rebuilt from the lag-reversed coefficient line per sequence tile.
//   Here a block owns one tile of TN rows (band_fit's tile: 128, or a halving
//   of it when REPRO_SKI_BAND_MAX asks for a narrower band), 8 batch rows and
//   4 channels (32 columns), and computes only the bw rows of z2 its hat rows
//   touch: the window starts at the node of the tile's first row (hat_row's
//   lo, so the window and the weights come from one computation), clamped to
//   r - bw. No (r, r) panel and no dense Gram exists anywhere, so r = 4096
//   and beyond run. The signal backward is this same kernel with the
//   coefficients lag-flipped (A^T of a Toeplitz matrix), the taps flipped
//   and left mirrored.
//   Bound: x, z, the coefficients and f read once and y written once: at
//   (8, 512, 512), r = 512, m = 32, 27,326,464 bytes, 8.16 us at 3.35 TB/s;
//   2 b d r^2 = 2,147 MFLOP for the Gram (the windows of neighbouring tiles
//   overlap by a few rows, about 6% more), 134 MFLOP conv and 8 MFLOP
//   expansion. The Gram runs on the tensor cores as three TF32 products
//   (6,442 MFLOP at 495 TFLOP/s, 13.0 us), the rest at 67 TFLOP/s fp32 on
//   the CUDA cores (2.1 us), which run beside the tensor cores: 13.0 us,
//   bound by operations (34.2 us were all of it on the CUDA cores).
//   Design (gram_window_tc): per channel the window is a (bw x r) Toeplitz
//   panel times z's (r x 8) batch columns, one mma.m16n8k8 TF32 per 16 rows
//   and 8 z rows, bw padded to MT = 9 m-tiles (3 for windows of 48 rows or
//   fewer). TF32 keeps 10 mantissa bits: one product put z2 off by up to
//   1.5e-3 at the path shape, over the 1e-5 x max tier, so each operand is
//   split once, v = hi + lo (both rounded to TF32), and the kernel sums
//   hi.hi + hi.lo + lo.hi ("3xTF32") in fp32, about as accurate as fp32
//   (tests/test_torch_ski_windowed_tc.py models it on the CPU). The A
//   fragments come straight from the coefficient line: a Toeplitz tile
//   depends on its diagonal alone, so a warp keeps a register window of
//   coefficients and reads two new ones a k-step. z and the coefficients
//   arrive in stages of 128 z rows by cp.async, the next stage landing
//   while the warps multiply the current one; the block splits a stage into
//   its TF32 halves once, for all its warps. Each of the 8 warps takes one
//   channel and 5 or 4 of the 9 m-tiles (rows 0-79 or 80-143), so it holds
//   20 accumulators, and sums every z row in one fixed order (no atomics:
//   bitwise the same from run to run). At the path shape a block holds
//   105,632 bytes of shared memory, 2 blocks a SM, 512 blocks: 1.94 waves
//   of 264. On an H100 (tools/ab_kernel.py ski, PERF.md) the mma loop
//   takes about 24 us of the kernel's 65; the stages' copies and split and
//   the tile's own copy, conv and store, which run after the Gram in each
//   block, take the rest. Earlier: one block per (tile, 32 columns) with
//   the Gram on the CUDA cores from a register window, 145.5-171.4 us,
//   bound by shared-memory issue (23 loads for 64 FMA).
//
// ski_expand_pass2  replaces the same _windowed_kernel / _windowed_call with
//   banded=False (ski_expand_pass2_pallas): the Gram-free pass 2 of the
//   FFT-Gram variant, y = W z2 + T_sparse x with z2 = A z applied outside
//   (rfft/irfft over the r inducing points). The same block and tile as
//   ski_windowed_pass2: the window's bw rows of z2 are copied (cp.async)
//   beside the x tile instead of computed. Bound: x, z2, f read once and y
//   written once, at (8, 512, 512), r = 512, m = 32, 25,231,360 bytes,
//   7.53 us at 3.35 TB/s (142 MFLOP, 2.1 us): bound by bytes.
//
//   Both take every n >= 2, 2 <= r <= n and 0 <= left < m themselves, n < m,
//   r = n and r < bw included (rows of the window past r are zero or unread):
//   the TPU wrapper's padding copies and its plain fallback for r < 2 or
//   bn < m have no counterpart. The conv over the tile and the two-tap
//   expansion from the window are conv_expand_store, the device function
//   that ski_fused_pass2 runs too.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kReduceThreads = 128;
constexpr int kExpandThreads = 256;
constexpr int kExpandRows = 8;   // rows of y an interp_expand block writes
constexpr int kLanes = 32;       // (batch row, channel) columns of a block
constexpr int kZ2Pitch = kLanes + 1;
constexpr int kMaxCB = 8;        // batch rows of a pass-2 block, at most
constexpr int kWarps = 8;        // pass-2 block: 8 warps, 256 threads
constexpr int kTN = 128;         // sequence rows per pass-2 tile
constexpr int kRowsPerThread = kTN / kWarps;  // consecutive rows a thread
constexpr int kKB = 8;           // conv taps per register window
constexpr int kStages = 4;       // x tile buffers in the ring, at most
constexpr int kBlocksPerSM = 3;  // pass-2 blocks aimed at per SM
constexpr int kMaxSmem = 232448; // bytes a block may use (227 KB)
constexpr int kSmemPerSM = 233472;  // bytes a SM holds for its blocks
constexpr int kMaxDevices = 64;  // devices with their own pass-2 state
constexpr int kGramC = 4;        // channels of a ski_windowed_pass2 block
constexpr int kStageT = 128;     // z rows of a Gram stage
constexpr int kMaxMT = 9;        // window m-tiles of 16 rows, at most
constexpr int kWindowedBlocksPerSM = 2;   // ski_windowed_pass2 blocks a SM

// The two taps of W's row i: node lo and weight w_lo (1 - w_lo on lo + 1).
__device__ __forceinline__ int hat_row(long long i, float hf, int r,
                                       float& w_lo) {
  const float f = __fdiv_rn((float)i, hf);
  int lo = (int)floorf(f);
  lo = lo < 0 ? 0 : (lo > r - 2 ? r - 2 : lo);
  w_lo = fminf(fmaxf(1.f - (f - (float)lo), 0.f), 1.f);
  return lo;
}

__global__ void __launch_bounds__(kReduceThreads)
    interp_reduce_kernel(const float* __restrict__ x, float* __restrict__ z,
                         long long n, long long d, int r, double h,
                         float hf) {
  __shared__ float ws[kReduceThreads];     // W[i, j] of a chunk of rows
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  const long long bi = blockIdx.z;
  // the positions with |i/h - j| < 1, one more on each side for rounding
  long long lo = (long long)ceil((j - 1) * h) - 1;
  long long hi = (long long)floor((j + 1) * h) + 1;
  lo = lo < 0 ? 0 : lo;
  hi = hi > n - 1 ? n - 1 : hi;
  const float* xb = x + bi * n * d + (c < d ? c : 0);
  float acc = 0.f;
  for (long long base = lo; base <= hi; base += kReduceThreads) {
    // the block's threads share the weights: one division per row
    const long long i = base + threadIdx.x;
    if (i <= hi) {
      float w_lo;
      const int node = hat_row(i, hf, r, w_lo);
      ws[threadIdx.x] = node == j ? w_lo : (node + 1 == j ? 1.f - w_lo : 0.f);
    }
    __syncthreads();
    const long long left_in_range = hi - base + 1;
    const int cnt = left_in_range < kReduceThreads ? (int)left_in_range
                                                   : kReduceThreads;
    if (c < d) {
#pragma unroll 8
      for (int q = 0; q < cnt; ++q) acc = fmaf(ws[q], xb[(base + q) * d], acc);
    }
    __syncthreads();
  }
  if (c < d) z[(bi * r + j) * d + c] = acc;
}

__global__ void __launch_bounds__(kExpandThreads)
    interp_expand_kernel(const float* __restrict__ z, float* __restrict__ y,
                         long long n, long long d, int r, float hf,
                         bool vec4) {
  __shared__ int slo[kExpandRows];         // node lo of the block's rows
  __shared__ float sw[kExpandRows];        // and w_lo
  const long long i0 = blockIdx.x * (long long)kExpandRows;
  const long long bi = blockIdx.y;
  const int rows = n - i0 < kExpandRows ? (int)(n - i0) : kExpandRows;
  if ((int)threadIdx.x < rows) {
    float w_lo;
    slo[threadIdx.x] = hat_row(i0 + threadIdx.x, hf, r, w_lo);
    sw[threadIdx.x] = w_lo;
  }
  __syncthreads();
  const float* zb = z + bi * r * d;
  float* yb = y + (bi * n + i0) * d;
  if (vec4) {
    const long long d4 = d / 4;
    for (long long e = threadIdx.x; e < rows * d4; e += kExpandThreads) {
      const int q = (int)(e / d4);
      const long long c4 = e - q * d4;
      const float wl = sw[q], wh = 1.f - wl;
      const float4 a = __ldg(reinterpret_cast<const float4*>(
                                 zb + slo[q] * d) + c4);
      const float4 b = __ldg(reinterpret_cast<const float4*>(
                                 zb + (slo[q] + 1) * d) + c4);
      float4 o;
      o.x = wl * a.x + wh * b.x;
      o.y = wl * a.y + wh * b.y;
      o.z = wl * a.z + wh * b.z;
      o.w = wl * a.w + wh * b.w;
      reinterpret_cast<float4*>(yb + q * d)[c4] = o;
    }
    return;
  }
  for (long long e = threadIdx.x; e < rows * d; e += kExpandThreads) {
    const int q = (int)(e / d);
    const long long c = e - q * d;
    const float wl = sw[q];
    yb[q * d + c] = wl * __ldg(zb + slo[q] * d + c) +
                    (1.f - wl) * __ldg(zb + (slo[q] + 1) * d + c);
  }
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdst),
               "l"(src), "r"(nbytes));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned),
// zero-filling when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst),
               "l"(src), "r"(nbytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` committed groups (the newest) are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// z tile pitch: a multiple of 4 floats (16-byte reads of z in the Gram).
__host__ __device__ __forceinline__ int z_pitch(long long r) {
  return (int)((r + 3) / 4 * 4 + 4);
}

// Floats of the z2 tile, [r][kZ2Pitch], rounded up to a multiple of 4 so
// that the x tiles after it stay 16-byte aligned for cp.async16 (r = 181 at
// d = 512, the dense ceiling, faulted with a misaligned address without it).
__host__ __device__ __forceinline__ int z2_floats(long long r) {
  return (int)((r * kZ2Pitch + 3) / 4 * 4);
}

// Taps rounded up to whole register windows.
__host__ __device__ __forceinline__ int padded_taps(long long m) {
  return (int)((m + kKB - 1) / kKB * kKB);
}

// Request x rows [i0 - hl, i0 - hl + rows) of the block's 32 columns into
// the tile buffer xs ([rows][kLanes]); rows outside [0, n) and columns past
// b or d are zero-filled. vec16 (8 batch rows x 4 channels, d % 4 == 0, x
// 16-byte aligned): one 16-byte copy per (row, batch row); otherwise one
// 4-byte copy per (row, column).
__device__ __forceinline__ void load_tile(float* xs, const float* x,
                                          long long b0, long long c0,
                                          long long i0, int hl, int rows,
                                          long long b, long long n,
                                          long long d, int cb, bool vec16) {
  if (vec16) {
    for (int e = threadIdx.x; e < rows * kMaxCB; e += kLanes * kWarps) {
      const int q = e / kMaxCB;
      const int bl = e - q * kMaxCB;
      const long long i = i0 - hl + q;
      const bool ok = b0 + bl < b && i >= 0 && i < n;
      cp_async16(xs + q * kLanes + bl * 4,
                 ok ? x + ((b0 + bl) * n + i) * d + c0 : x, ok);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int kc = kLanes / cb;
  const long long bg = b0 + lane / kc;
  const long long c = c0 + lane % kc;
  const bool valid = bg < b && c < d;
  for (int q = threadIdx.x >> 5; q < rows; q += kWarps) {
    const long long i = i0 - hl + q;
    const bool ok = valid && i >= 0 && i < n;
    cp_async4(xs + q * kLanes + lane, ok ? x + (bg * n + i) * d + c : x, ok);
  }
}

// The conv over a tile and the two-tap expansion, one store: output rows
// row0 .. row0 + RPT - 1 of the tile (row0 = warp * RPT) in column lane.
// xt is the tile with its halo ([TN + mp - 1][kLanes], tile row q holding x
// row i0 - (mp - 1 - left) + q), fs the taps ([mp][kLanes], zero past m),
// z2w the rows of z2 from node w0 on ([.][kZ2Pitch]), hlo / hw the tile
// rows' nodes and weights. Output row row0 + q with tap k reads tile row
// row0 + q - k + mp - 1; the kKB + RPT - 1 rows a block of kKB taps needs
// sit in registers, so each x value is read from shared memory once a block.
template <int RPT>
__device__ __forceinline__ void conv_expand_store(
    const float* xt, const float* fs, int mp, const float* z2w, int w0,
    const int* hlo, const float* hw, float* __restrict__ y, long long i0,
    long long n, long long d, long long bg, long long c, bool valid) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  float acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
  for (int kb = 0; kb < mp; kb += kKB) {
    const float* xr = xt + (row0 + mp - kb - kKB) * kLanes + lane;
    float xw[RPT + kKB - 1];
#pragma unroll
    for (int e = 0; e < RPT + kKB - 1; ++e) xw[e] = xr[e * kLanes];
    float fk[kKB];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) fk[kk] = fs[(kb + kk) * kLanes + lane];
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk)
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        acc[q] = fmaf(fk[kk], xw[q + kKB - 1 - kk], acc[q]);
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const long long i = i0 + row0 + q;
    if (i < n && valid) {
      const int lo = hlo[row0 + q] - w0;
      const float wl = hw[row0 + q];
      const float low = wl * z2w[lo * kZ2Pitch + lane] +
                        (1.f - wl) * z2w[(lo + 1) * kZ2Pitch + lane];
      y[(bg * n + i) * d + c] = low + acc[q];
    }
  }
}

// One block: cb batch rows x kc = 32/cb channels, its 32 (batch row,
// channel) columns laid along a warp's lanes, lane = row * kc + channel.
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
    ski_fused_pass2_kernel(const float* __restrict__ x,
                           const float* __restrict__ z,
                           const float* __restrict__ a,
                           const float* __restrict__ filt,
                           float* __restrict__ y, long long b, long long n,
                           long long d, int r, int m, int left, float hf,
                           int cb, bool a_vec4, bool x_vec16,
                           long long tiles_per_block, int nbuf) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kc = kLanes / cb;
  const long long b0 = (long long)blockIdx.y * cb;
  const long long c0 = (long long)blockIdx.x * kc;
  const long long bg = b0 + lane / kc;
  const long long c = c0 + lane % kc;
  const bool valid = bg < b && c < d;
  const int zp = z_pitch(r);
  const int mp = padded_taps(m);       // taps m..mp-1 are zero
  const int rows = kTN + mp - 1;       // tile rows with the conv halo
  const int hl = mp - 1 - left;        // halo rows before the tile
  float* zs = smem;                    // [kLanes][zp]   z[bg, t, c]
  float* z2s = zs + kLanes * zp;       // [r][kZ2Pitch]  z2[bg, s, c]
  float* fs = z2s + z2_floats(r);      // [mp][kLanes]   f[c, k]
  float* xs = fs + mp * kLanes;        // nbuf x [rows][kLanes] x tiles
  float* hw = xs + nbuf * rows * kLanes;        // [kTN] w_lo of a tile's rows
  int* hlo = reinterpret_cast<int*>(hw + kTN);  // [kTN] their nodes
  const long long ntiles = (n + kTN - 1) / kTN;
  const long long t0 = blockIdx.z * tiles_per_block;   // this block's tiles
  const long long t1 = t0 + tiles_per_block < ntiles ? t0 + tiles_per_block
                                                      : ntiles;

  // 1. the block's first tiles (nbuf - 1 of them, at least one) stream in
  //    while the Gram runs. Tile t0 + j is always cp.async group j.
  const int ahead = nbuf > 1 ? nbuf - 1 : 1;    // tiles requested ahead
  for (int j = 0; j < ahead; ++j) {
    if (t0 + j < t1)
      load_tile(xs + j * rows * kLanes, x, b0, c0, (t0 + j) * kTN, hl, rows,
                b, n, d, cb, x_vec16);
    cp_async_commit();                 // possibly empty: keeps the count
  }

  // 2. z columns, transposed, and the taps
  for (int t = warp; t < r; t += kWarps)
    zs[lane * zp + t] = valid ? z[(bg * r + t) * d + c] : 0.f;
  for (int k = warp; k < mp; k += kWarps)
    fs[k * kLanes + lane] = valid && k < m ? filt[c * m + k] : 0.f;
  __syncthreads();

  // 3. z2 = A z: a thread takes one row s of one channel's A, reads it once
  //    and applies it to the block's cb batch rows; a warp's threads share
  //    the channel, so each z value they read is one broadcast
  for (int p = threadIdx.x; p < kc * r; p += kLanes * kWarps) {
    const int gc = p / r;
    const int s = p - gc * r;
    float acc[kMaxCB];
#pragma unroll
    for (int u = 0; u < kMaxCB; ++u) acc[u] = 0.f;
    if (c0 + gc < d) {
      const float* arow = a + ((c0 + gc) * r + s) * (long long)r;
      if (a_vec4) {
        const float4* a4 = reinterpret_cast<const float4*>(arow);
#pragma unroll 8
        for (int t4 = 0; t4 < r / 4; ++t4) {
          const float4 v = __ldg(a4 + t4);
#pragma unroll
          for (int u = 0; u < kMaxCB; ++u) {
            if (u < cb) {
              const float4 zu = *reinterpret_cast<const float4*>(
                  zs + (u * kc + gc) * zp + 4 * t4);
              acc[u] = fmaf(v.x, zu.x, acc[u]);
              acc[u] = fmaf(v.y, zu.y, acc[u]);
              acc[u] = fmaf(v.z, zu.z, acc[u]);
              acc[u] = fmaf(v.w, zu.w, acc[u]);
            }
          }
        }
      } else {
        for (int t = 0; t < r; ++t) {
          const float v = __ldg(arow + t);
#pragma unroll
          for (int u = 0; u < kMaxCB; ++u)
            if (u < cb) acc[u] = fmaf(v, zs[(u * kc + gc) * zp + t], acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxCB; ++u)
      if (u < cb) z2s[s * kZ2Pitch + u * kc + gc] = acc[u];
  }

  // 4. stream the block's tiles: conv from the tile, expansion from z2, one
  //    store
  for (long long tile = t0; tile < t1; ++tile) {
    const long long k = tile - t0;
    const float* cur = xs + (k % nbuf) * rows * kLanes;
    if (nbuf > 1) {                    // into the buffer freed last time
      if (tile + ahead < t1)
        load_tile(xs + ((k + ahead) % nbuf) * rows * kLanes, x, b0, c0,
                  (tile + ahead) * kTN, hl, rows, b, n, d, cb, x_vec16);
      cp_async_commit();               // group k + ahead, possibly empty
    }
    if (threadIdx.x < kTN) {           // W's rows of the tile, once each
      float w_lo;
      hlo[threadIdx.x] = hat_row(tile * kTN + threadIdx.x, hf, r, w_lo);
      hw[threadIdx.x] = w_lo;
    }
    cp_async_wait(nbuf - 1);           // this tile's copies have landed
    __syncthreads();
    conv_expand_store<kRowsPerThread>(cur, fs, mp, z2s, 0, hlo, hw, y,
                                      tile * kTN, n, d, bg, c, valid);
    __syncthreads();                   // before the buffers are refilled
    if (nbuf == 1) {                   // one buffer: the next tile now
      if (tile + 1 < t1)
        load_tile(xs, x, b0, c0, (tile + 1) * kTN, hl, rows, b, n, d, cb,
                  x_vec16);
      cp_async_commit();               // group k + 1
    }
  }
}


// d += a b, m16n8k8, TF32 operands (fp32 bit patterns, low 13 bits zero),
// fp32 accumulators. Fragments (g = lane / 4, t4 = lane % 4): a0 (row g,
// col t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4); b0 (k t4,
// col g), b1 (k t4 + 4, col g); d0, d1 (row g, cols 2 t4, 2 t4 + 1), d2, d3
// (row g + 8, the same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero as cvt.rna.tf32.f32 rounds: half of the 13 dropped bits added to the
// magnitude, then the 13 bits cleared.
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}

// Coefficient slots of a Gram stage for a window of mt m-tiles: the
// coefficients one channel's 16 mt window rows and the stage's kStageT z
// rows reach (16 mt + kStageT - 1), one slot of slack.
__host__ __device__ __forceinline__ int gram_span(int mt) {
  return 16 * mt + kStageT;
}

// Floats of the banded kernel's Gram staging for mt m-tiles: the raw stage
// (z [kStageT][kLanes], the kGramC channels' coefficients [kGramC][span]),
// then its hi and lo TF32 halves (z [kGramC][kStageT][kMaxCB] and the
// coefficients again).
__host__ __device__ __forceinline__ int gram_stage_floats(int mt) {
  return 3 * (kStageT * kLanes + kGramC * gram_span(mt));
}

// Request Gram stage t0 .. t0 + kStageT - 1 into the raw buffers: z rows of
// the block's 32 columns as zr[t][lane] (lane = batch row * 4 + channel;
// 16-byte copies of 4 channels when vec16), and coefficients
// base .. base + span - 1 of its kGramC channels as cr[ch][e]; zero past r,
// b, d and outside [0, 2r - 1).
__device__ __forceinline__ void load_gram_stage(
    float* zr, float* cr, const float* z, const float* coef, long long b0,
    long long c0, int t0, long long base, int span, int r, long long b,
    long long d, bool vec16) {
  if (vec16) {
    for (int e = threadIdx.x; e < kStageT * kMaxCB; e += kLanes * kWarps) {
      const int t = e >> 3, u = e & 7;
      const bool ok = b0 + u < b && t0 + t < r;
      cp_async16(zr + 4 * e, ok ? z + ((b0 + u) * r + t0 + t) * d + c0 : z,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < kStageT * kLanes; e += kLanes * kWarps) {
      const int t = e >> 5, u = (e >> 2) & 7, ch = e & 3;
      const bool ok = b0 + u < b && c0 + ch < d && t0 + t < r;
      cp_async4(zr + e, ok ? z + ((b0 + u) * r + t0 + t) * d + c0 + ch : z,
                ok);
    }
  }
  const long long ncoef = 2LL * r - 1;
  for (int p = threadIdx.x; p < kGramC * span; p += kLanes * kWarps) {
    const int ch = p / span;
    const long long idx = base + (p - ch * span);
    const bool ok = c0 + ch < d && idx >= 0 && idx < ncoef;
    cp_async4(cr + p, ok ? coef + (c0 + ch) * ncoef + idx : coef, ok);
  }
}

// The raw stage split into TF32 halves, v = hi + lo with hi = rna(v) and
// lo = rna(v - hi): z transposed to [ch][t][batch row] (a B fragment's 32
// lanes then read 32 consecutive words), the coefficients in place.
__device__ __forceinline__ void split_gram_stage(const float* zr,
                                                 const float* cr, float* zh,
                                                 float* zl, float* csh,
                                                 float* csl, int span) {
  for (int e = threadIdx.x; e < kStageT * kMaxCB; e += kLanes * kWarps) {
    const float4 v = *reinterpret_cast<const float4*>(zr + 4 * e);
    const float vs[kGramC] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int ch = 0; ch < kGramC; ++ch) {
      const float hi = tf32_rna(vs[ch]);
      zh[ch * kStageT * kMaxCB + e] = hi;    // e = t * kMaxCB + batch row
      zl[ch * kStageT * kMaxCB + e] = tf32_rna(vs[ch] - hi);
    }
  }
  for (int p = threadIdx.x; p < kGramC * span; p += kLanes * kWarps) {
    const float v = cr[p];
    const float hi = tf32_rna(v);
    csh[p] = hi;
    csl[p] = tf32_rna(v - hi);
  }
}

// One warp's share of a Gram stage: acc[mi] += A[16 (m0 + mi) .., t]
// z[t, ..] for mi < NM over the stage's kStageT / 8 k-steps of 8 z rows,
// for one channel, in 3xTF32: hi.hi and hi.lo in a first sweep, lo.hi in
// a second, all into the same fp32 accumulators in a fixed order.
//
// A[j, t] = coef[w0 + j - t + r - 1] is Toeplitz, so the A fragment of
// m-tile mi at k-step ks depends on 2 mi - ks alone: its four values are
// stage coefficient slots e0 + 4 i for window indices i = q - 1, q, q + 1,
// q + 2 with q = 4 mi - 2 ks + 2 kSteps - 1 (a2, a0, a3, a1), e0 =
// 16 m0 + 3 + g - t4. A warp keeps the window w[i] in registers: k-step 0
// reads i = 2 kSteps - 2 .. 4 NM + 2 kSteps - 3, each later k-step two
// more (i = 2 kSteps - 2 - 2 ks and one above); the rest carry over, as
// the diagonals repeat (m-tile mi + 1 at k-step ks + 2 is m-tile mi at
// ks). A thread's slots are 11 consecutive words across the warp: no bank
// conflicts.
template <int MA, int NM>
__device__ __forceinline__ void gram_stage_mma(float (&acc)[MA][4],
                                               const float* zh,
                                               const float* zl,
                                               const float* csh,
                                               const float* csl, int m0) {
  constexpr int kSteps = kStageT / 8;            // k-steps of 8 z rows
  constexpr int W = 4 * NM + 2 * kSteps - 2;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int e0 = 16 * m0 + 3 + g - t4;
  const int zo = t4 * kMaxCB + g;                  // b0 of k-step 0
#pragma unroll
  for (int sweep = 0; sweep < 2; ++sweep) {
    const float* cw = (sweep == 0 ? csh : csl) + e0;
    uint32_t w[W];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if (ks == 0) {
#pragma unroll
        for (int i = 2 * kSteps - 2; i < W; ++i)
          w[i] = __float_as_uint(cw[4 * i]);
      } else {
        w[2 * kSteps - 2 - 2 * ks] =
            __float_as_uint(cw[4 * (2 * kSteps - 2 - 2 * ks)]);
        w[2 * kSteps - 1 - 2 * ks] =
            __float_as_uint(cw[4 * (2 * kSteps - 1 - 2 * ks)]);
      }
      const int zk = zo + 8 * kMaxCB * ks;
      const uint32_t bh0 = __float_as_uint(zh[zk]);
      const uint32_t bh1 = __float_as_uint(zh[zk + 4 * kMaxCB]);
#pragma unroll
      for (int mi = 0; mi < NM; ++mi) {
        const int q = 4 * mi - 2 * ks + 2 * kSteps - 1;
        mma_tf32(acc[mi], w[q], w[q + 2], w[q - 1], w[q + 1], bh0, bh1);
      }
      if (sweep == 0) {
        const uint32_t bl0 = __float_as_uint(zl[zk]);
        const uint32_t bl1 = __float_as_uint(zl[zk + 4 * kMaxCB]);
#pragma unroll
        for (int mi = 0; mi < NM; ++mi) {
          const int q = 4 * mi - 2 * ks + 2 * kSteps - 1;
          mma_tf32(acc[mi], w[q], w[q + 2], w[q - 1], w[q + 1], bl0, bl1);
        }
      }
    }
  }
}

// z2w[j][lane] = sum_{t<r} coef[c, w0 + j - t + r - 1] z[bg, t, c] for
// j < bw, on the tensor cores. Warp w takes channel w % 4 and window
// m-tiles [m0, m0 + nm) with m0 = 0, nm = (MT + 1) / 2 for w < 4 and the
// rest for w >= 4. The stages of kStageT z rows stream through the raw
// buffers by cp.async (stage s + 1 lands while stage s multiplies) and
// are split into TF32 halves once, for every warp.
template <int MT>
__device__ __forceinline__ void gram_window_tc(
    const float* __restrict__ z, const float* __restrict__ coef, float* z2w,
    float* stage, int w0, int bw, int r, long long b, long long d,
    long long b0, long long c0, bool z_vec16) {
  constexpr int MA = (MT + 1) / 2, MB = MT / 2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ch = warp & (kGramC - 1), half = warp / kGramC;
  const int m0 = half ? MA : 0, nm = half ? MB : MA;
  const int span = gram_span(MT);
  float* zr = stage;                             // raw stage
  float* cr = zr + kStageT * kLanes;
  float* zh = cr + kGramC * span;                // its TF32 halves
  float* zl = zh + kStageT * kLanes;
  float* csh = zl + kStageT * kLanes;
  float* csl = csh + kGramC * span;
  float acc[MA][4];
#pragma unroll
  for (int mi = 0; mi < MA; ++mi)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[mi][k] = 0.f;
  const int nst = (r + kStageT - 1) / kStageT;
  // stage s needs coefficient indices base .. base + span - 1,
  // base = w0 + r - kStageT - s kStageT; the caller requested stage 0
  for (int s = 0; s < nst; ++s) {
    cp_async_wait(0);                  // stage s (and the x tile) landed
    __syncthreads();                   // ... for every thread; halves free
    split_gram_stage(zr, cr, zh, zl, csh, csl, span);
    __syncthreads();                   // halves ready; the raw buffers free
    if (s + 1 < nst) {
      load_gram_stage(zr, cr, z, coef, b0, c0, (s + 1) * kStageT,
                      (long long)w0 + r - kStageT - (s + 1) * kStageT, span,
                      r, b, d, z_vec16);
      cp_async_commit();
    }
    const float* zhc = zh + ch * kStageT * kMaxCB;
    const float* zlc = zl + ch * kStageT * kMaxCB;
    if (half == 0)
      gram_stage_mma<MA, MA>(acc, zhc, zlc, csh + ch * span, csl + ch * span,
                             m0);
    else
      gram_stage_mma<MA, MB>(acc, zhc, zlc, csh + ch * span, csl + ch * span,
                             m0);
  }
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MA; ++mi)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 16 * (m0 + mi) + g + 8 * (k >> 1);
      if (mi < nm && j < bw)
        z2w[j * kZ2Pitch + (2 * t4 + (k & 1)) * kGramC + ch] = acc[mi][k];
    }
}

// One block: one tile of TN sequence rows (RPT = TN / kWarps a thread) and
// cb batch rows x kc = 32/cb channels, lane = row * kc + channel, as in
// ski_fused_pass2. kBanded (ski_windowed_pass2; cb = 8, kc = kGramC): the
// window of z2 = A z is computed from z and the coefficients on the tensor
// cores, MT m-tiles of 16 rows covering bw; otherwise z holds z2 and the
// window is copied (ski_expand_pass2; coef unused).
template <int TN, bool kBanded, int MT>
__global__ void __launch_bounds__(kLanes * kWarps,
                                  kBanded ? kWindowedBlocksPerSM
                                          : kBlocksPerSM)
    ski_window_pass2_kernel(const float* __restrict__ x,
                            const float* __restrict__ z,
                            const float* __restrict__ coef,
                            const float* __restrict__ filt,
                            float* __restrict__ y, long long b, long long n,
                            long long d, int r, int m, int left, float hf,
                            int cb, int bw, bool x_vec16, bool z_vec16) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kc = kLanes / cb;
  const long long i0 = (long long)blockIdx.x * TN;     // the tile's first row
  const long long c0 = (long long)blockIdx.y * kc;
  const long long b0 = (long long)blockIdx.z * cb;
  const long long bg = b0 + lane / kc;
  const long long c = c0 + lane % kc;
  const bool valid = bg < b && c < d;
  const int mp = padded_taps(m);        // taps m..mp-1 are zero
  const int rows = TN + mp - 1;         // tile rows with the conv halo
  float* xs = smem;                     // [rows][kLanes]  x tile (16-byte
                                        //   aligned: first)
  float* fs = xs + rows * kLanes;       // [mp][kLanes]    f[c, k]
  float* z2w = fs + mp * kLanes;        // [bw][kZ2Pitch]  z2[bg, w0 + j, c]
  float* hw = z2w + bw * kZ2Pitch;      // [TN] w_lo of the tile's rows
  int* hlo = reinterpret_cast<int*>(hw + TN);          // [TN] their nodes
  float* stage = reinterpret_cast<float*>(hlo + TN);   // banded: Gram stages
  // the window's first node: that of the tile's first row, clamped so that
  // the bw rows stay inside [0, r) (from 0 when r < bw)
  float wl0;
  int w0 = hat_row(i0, hf, r, wl0);
  const int w0_max = r > bw ? r - bw : 0;
  w0 = w0 < w0_max ? w0 : w0_max;

  // 1. the x tile with its halo (banded: and the Gram's first stage; else
  //    the window of z2) streams in while the taps and the hat rows are made
  load_tile(xs, x, b0, c0, i0, mp - 1 - left, rows, b, n, d, cb, x_vec16);
  if constexpr (kBanded) {
    cp_async_commit();
    const int span = gram_span(MT);
    load_gram_stage(stage, stage + kStageT * kLanes, z, coef, b0, c0, 0,
                    (long long)w0 + r - kStageT, span, r, b, d, z_vec16);
  } else {
    for (int j = warp; j < bw; j += kWarps) {
      const long long t = w0 + j;
      const bool ok = valid && t < r;
      cp_async4(z2w + j * kZ2Pitch + lane, ok ? z + (bg * r + t) * d + c : z,
                ok);
    }
  }
  cp_async_commit();
  for (int k = warp; k < mp; k += kWarps)
    fs[k * kLanes + lane] = valid && k < m ? filt[c * m + k] : 0.f;
  if (threadIdx.x < TN) {
    float w_lo;
    hlo[threadIdx.x] = hat_row(i0 + threadIdx.x, hf, r, w_lo);
    hw[threadIdx.x] = w_lo;
  }
  // 2. banded: the window of z2 = A z
  if constexpr (kBanded)
    gram_window_tc<MT>(z, coef, z2w, stage, w0, bw, r, b, d, b0, c0,
                       z_vec16);
  cp_async_wait(0);
  __syncthreads();
  // 3. conv, expansion, one store
  conv_expand_store<TN / kWarps>(xs, fs, mp, z2w, w0, hlo, hw, y, i0, n, d,
                                 bg, c, valid);
}

}  // namespace


// Batch rows of a pass-2 block: 8 (A, or its coefficients, then serve 8 rows
// at once), fewer for a smaller batch so that no lane idles; the rest of
// the 32 lanes are channels.
static int batch_rows(long long b) {
  int cb = 1;
  while (cb < kMaxCB && cb < b) cb *= 2;
  return cb;
}

// Window m-tiles of the banded kernel for a window of bw rows: 3 for
// ceil(bw / 16) <= 3 (every tile of 32 rows or fewer), else kMaxMT; 0 when
// bw needs more than kMaxMT (band_fit's windows never do: bw <= 136).
static int gram_mt(long long bw) {
  const long long mt = (bw + 15) / 16;
  return mt <= 3 ? 3 : (mt <= kMaxMT ? kMaxMT : 0);
}

// Dynamic shared memory of a windowed pass-2 block, bytes: the x tile of tn
// rows with its halo, the taps, bw window rows of z2 and the hat rows; the
// banded kernel adds its Gram staging.
static long long window_smem(long long tn, long long bw, long long m,
                             bool banded) {
  const long long mp = padded_taps(m);
  long long floats =
      (tn + mp - 1) * kLanes + mp * kLanes + bw * kZ2Pitch + 2 * tn;
  if (banded) floats += gram_stage_floats(gram_mt(bw));
  return 4 * floats;
}

template <int TN, bool kBanded, int MT>
static int window_launch(const dim3& grid, long long smem, cudaStream_t s,
                         const void* x, const void* z, const void* coef,
                         const void* filt, void* y, long long b, long long n,
                         long long d, long long r, long long m,
                         long long left, float hf, int cb, long long bw,
                         bool x_vec16, bool z_vec16) {
  // the dynamic shared memory this kernel's attribute allows, per device
  // (the attribute is per device; 48 KB until raised)
  static long long smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(ski_window_pass2_kernel<TN, kBanded, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = smem;
  }
  ski_window_pass2_kernel<TN, kBanded, MT>
      <<<grid, kLanes * kWarps, (size_t)smem, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(z),
          static_cast<const float*>(coef), static_cast<const float*>(filt),
          static_cast<float*>(y), b, n, d, (int)r, (int)m, (int)left, hf, cb,
          (int)bw, x_vec16, z_vec16);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBanded>
static int window_pass2(const void* x, const void* z, const void* coef,
                        const void* filt, void* y, long long b, long long n,
                        long long d, long long r, long long m, long long left,
                        float hf, long long tn, long long bw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tn < 8) return static_cast<int>(cudaErrorInvalidValue);
  // banded: 8 batch rows x kGramC channels a block, the tensor cores' n = 8
  const int cb = kBanded ? kMaxCB : batch_rows(b);
  const int kc = kLanes / cb;
  const int mt = kBanded ? gram_mt(bw) : 0;
  const long long tiles = (n + tn - 1) / tn;
  const long long gx = (d + kc - 1) / kc, gy = (b + cb - 1) / cb;
  const long long smem = window_smem(tn, bw, m, kBanded);
  if (smem > kMaxSmem || tiles > 2147483647LL || gx > 65535 || gy > 65535 ||
      bw < 8 || bw % 8 != 0 || (kBanded && mt == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool x_vec16 = cb == kMaxCB && d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool z_vec16 = kBanded && d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const dim3 grid((unsigned)tiles, (unsigned)gx, (unsigned)gy);
#define REPRO_WINDOW_CASE(TN, MT)                                            \
  case TN:                                                                   \
    return window_launch<TN, kBanded, MT>(grid, smem, s, x, z, coef, filt, y, \
                                          b, n, d, r, m, left, hf, cb, bw,    \
                                          x_vec16, z_vec16);
  if constexpr (!kBanded) {
    switch (tn) {
      REPRO_WINDOW_CASE(128, 0)
      REPRO_WINDOW_CASE(64, 0)
      REPRO_WINDOW_CASE(32, 0)
      REPRO_WINDOW_CASE(16, 0)
      REPRO_WINDOW_CASE(8, 0)
    }
  } else if (mt == 3) {
    switch (tn) {
      REPRO_WINDOW_CASE(128, 3)
      REPRO_WINDOW_CASE(64, 3)
      REPRO_WINDOW_CASE(32, 3)
      REPRO_WINDOW_CASE(16, 3)
      REPRO_WINDOW_CASE(8, 3)
    }
  } else {                             // tiles of 64 rows or more
    switch (tn) {
      REPRO_WINDOW_CASE(128, kMaxMT)
      REPRO_WINDOW_CASE(64, kMaxMT)
    }
  }
#undef REPRO_WINDOW_CASE
  return static_cast<int>(cudaErrorInvalidValue);   // not a band_fit tile
}

extern "C" {

// Dynamic shared memory of one pass-2 block with nbuf tile buffers, bytes.
static long long pass2_smem(long long r, long long m, long long nbuf) {
  const long long mp = padded_taps(m);
  return 4 * (kLanes * z_pitch(r) + z2_floats(r) + mp * kLanes +
              nbuf * (kTN + mp - 1) * kLanes + 2 * kTN);
}

// The least dynamic shared memory of a pass-2 block (one tile buffer).
long long ski_fused_pass2_smem_bytes(long long r, long long m) {
  return pass2_smem(r, m, 1);
}

// x: (b, n, d), z: (b, r, d) contiguous fp32 on the device; h = (n-1)/(r-1)
// and hf = float32(h). Returns cudaGetLastError().
int interp_reduce_f32(const void* x, void* z, long long b, long long n,
                      long long d, long long r, double h, float hf,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((d + kReduceThreads - 1) / kReduceThreads),
                  (unsigned)r, (unsigned)b);
  interp_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(z), n, d, (int)r, h,
      hf);
  return static_cast<int>(cudaGetLastError());
}

// z: (b, r, d), y: (b, n, d) contiguous fp32 on the device; 2 <= r <= n and
// hf = float32((n-1)/(r-1)). Returns cudaGetLastError(), or
// cudaErrorInvalidValue when the grid exceeds its bounds.
int interp_expand_f32(const void* z, void* y, long long b, long long n,
                      long long d, long long r, float hf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (n + kExpandRows - 1) / kExpandRows;
  if (blocks > 2147483647LL || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((unsigned)blocks, (unsigned)b);
  interp_expand_kernel<<<grid, kExpandThreads, 0, s>>>(
      static_cast<const float*>(z), static_cast<float*>(y), n, d, (int)r, hf,
      vec4);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (b, n, d); z: (b, r, d); a: (d, r, r); filt: (d, m), contiguous fp32
// on the device; 0 <= left < m; hf = float32((n-1)/(r-1)).
// Returns cudaGetLastError(), or cudaErrorInvalidValue when the block's
// shared memory would exceed the card's limit.
int ski_fused_pass2_f32(const void* x, const void* z, const void* a,
                        const void* filt, void* y, long long b, long long n,
                        long long d, long long r, long long m, long long left,
                        float hf, void* stream) {
  // per device: its SM count (0: not read yet), and the dynamic shared
  // memory the kernel's attribute allows there (the attribute is per device)
  struct DeviceState {
    int sms = 0;
    long long smem_set = 48 * 1024;
  };
  static DeviceState devices[kMaxDevices];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int& sms = devices[dev].sms;
  long long& smem_set = devices[dev].smem_set;
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cb = batch_rows(b);
  const int kc = kLanes / cb;
  const long long gx = (d + kc - 1) / kc, gy = (b + cb - 1) / cb;
  // the sequence's tiles split over blocks until about kBlocksPerSM blocks
  // a SM run (each recomputes its columns' z2 = A z, a small part of its
  // work at r << n)
  const long long ntiles = (n + kTN - 1) / kTN;
  long long splits = (long long)kBlocksPerSM * sms / (gx * gy);
  splits = splits < 1 ? 1 : (splits > ntiles ? ntiles : splits);
  const long long per_block = (ntiles + splits - 1) / splits;
  splits = (ntiles + per_block - 1) / per_block;
  // as many tile buffers as the block has tiles, up to kStages, while
  // kBlocksPerSM blocks still fit a SM's shared memory (1 KB of it is
  // reserved for each block)
  int nbuf = per_block < kStages ? (int)per_block : kStages;
  while (nbuf > 1 && (pass2_smem(r, m, nbuf) + 1024) * kBlocksPerSM >
                         kSmemPerSM)
    --nbuf;
  const long long smem = pass2_smem(r, m, nbuf);
  if (smem > kMaxSmem || gy > 65535 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > smem_set) {
    e = cudaFuncSetAttribute(ski_fused_pass2_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const bool a_vec4 = r % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool x_vec16 = cb == kMaxCB && d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)splits);
  ski_fused_pass2_kernel<<<grid, kLanes * kWarps, (size_t)smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<const float*>(a), static_cast<const float*>(filt),
      static_cast<float*>(y), b, n, d, (int)r, (int)m, (int)left, hf, cb,
      a_vec4, x_vec16, per_block, nbuf);
  return static_cast<int>(cudaGetLastError());
}


// Dynamic shared memory of a windowed pass-2 block (banded: the Gram's
// chunks included) for a batch of b rows, a tile of tn rows, a window of
// bw rows and m taps, bytes.
long long ski_window_pass2_smem_bytes(long long b, long long tn, long long bw,
                                      long long m, int banded) {
  // The layout is the same for every b. b stays in the signature so that
  // builds of earlier versions of this file load behind the same Python
  // wrapper (tools/ab_kernel.py --old).
  (void)b;
  return window_smem(tn, bw, m, banded != 0);
}

// Blocks of ski_windowed_pass2 an SM holds at the large-rank path's shape
// (a tile of 128 rows, a window of 136, m = 32) on the current device, its
// shared-memory attribute raised first; or minus a CUDA error.
int ski_windowed_pass2_blocks_per_sm() {
  const long long smem = window_smem(kTN, 136, 32, true);
  cudaError_t e = cudaFuncSetAttribute(
      ski_window_pass2_kernel<kTN, true, kMaxMT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, ski_window_pass2_kernel<kTN, true, kMaxMT>, kLanes * kWarps,
      (size_t)smem);
  return e != cudaSuccess ? -static_cast<int>(e) : nb;
}

// x, y: (b, n, d); z: (b, r, d); coef: (d, 2r-1); filt: (d, m), contiguous
// fp32 on the device; 2 <= r <= n, 0 <= left < m, hf = float32((n-1)/(r-1));
// (tn, bw) from band_fit (tn in {128, 64, 32, 16, 8}, bw a multiple of 8).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a tile, window,
// grid or shared memory the kernel does not take.
int ski_windowed_pass2_f32(const void* x, const void* z, const void* coef,
                           const void* filt, void* y, long long b,
                           long long n, long long d, long long r, long long m,
                           long long left, float hf, long long tn,
                           long long bw, void* stream) {
  return window_pass2<true>(x, z, coef, filt, y, b, n, d, r, m, left, hf, tn,
                            bw, stream);
}

// As ski_windowed_pass2_f32 with z2 = A z (b, r, d) in place of z and no
// coefficients.
int ski_expand_pass2_f32(const void* x, const void* z2, const void* filt,
                         void* y, long long b, long long n, long long d,
                         long long r, long long m, long long left, float hf,
                         long long tn, long long bw, void* stream) {
  return window_pass2<false>(x, z2, nullptr, filt, y, b, n, d, r, m, left, hf,
                             tn, bw, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
