// Hand-written Hopper (sm_90a) kernels of the dense fused SKI-TNO forward
// (paper §3.2, Algorithm 1): y = W (A (W^T x)) + T_sparse x, bound to
// PyTorch through a plain C interface (ctypes) by
// src/repro_torch/kernels/interp_matvec.py and ski_fused.py. x, y are
// (b, n, d) fp32, z = W^T x is (b, r, d), A is the (d, r, r) per-channel
// inducing Gram and f the (d, m) short-conv taps, all contiguous.
//
// W is the linear interpolation onto r uniform inducing points with spacing
// h = (n-1)/(r-1): row i has two taps, w_lo on node lo = floor(i/h) and
// 1 - w_lo on lo + 1, with lo clamped to [0, r-2] and w_lo = 1 - (i/h - lo)
// clamped to [0, 1]. Both kernels regenerate it from (n, r) in fp32 exactly
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

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kReduceThreads = 128;
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
  const int row0 = warp * kRowsPerThread;   // this thread's rows in a tile
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
    // conv, kKB taps at a time: output row row0 + q with tap k reads tile
    // row row0 + q - k + mp - 1; the kKB + 15 rows a tap block needs sit in
    // registers, so each x value is read from shared memory once a block
    float acc[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.f;
    for (int kb = 0; kb < mp; kb += kKB) {
      const float* xr = cur + (row0 + mp - kb - kKB) * kLanes + lane;
      float xw[kRowsPerThread + kKB - 1];
#pragma unroll
      for (int e = 0; e < kRowsPerThread + kKB - 1; ++e)
        xw[e] = xr[e * kLanes];
      float fk[kKB];
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk) fk[kk] = fs[(kb + kk) * kLanes + lane];
#pragma unroll
      for (int kk = 0; kk < kKB; ++kk)
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          acc[q] = fmaf(fk[kk], xw[q + kKB - 1 - kk], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const long long i = tile * kTN + row0 + q;
      if (i < n && valid) {
        const int lo = hlo[row0 + q];
        const float wl = hw[row0 + q];
        const float low = wl * z2s[lo * kZ2Pitch + lane] +
                          (1.f - wl) * z2s[(lo + 1) * kZ2Pitch + lane];
        y[(bg * n + i) * d + c] = low + acc[q];
      }
    }
    __syncthreads();                   // before the buffers are refilled
    if (nbuf == 1) {                   // one buffer: the next tile now
      if (tile + 1 < t1)
        load_tile(xs, x, b0, c0, (tile + 1) * kTN, hl, rows, b, n, d, cb,
                  x_vec16);
      cp_async_commit();               // group k + 1
    }
  }
}

}  // namespace

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
  // batch rows a block: 8 (A is then read once per 8 rows), fewer for a
  // smaller batch so that no lane idles; the rest of the 32 lanes are
  // channels
  int cb = 1;
  while (cb < kMaxCB && cb < b) cb *= 2;
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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
