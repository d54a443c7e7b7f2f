// Hand-written Hopper (sm_90a) kernels of the fused SKI-TNO backward's
// parameter cotangents (paper §3.2), bound to PyTorch through a plain C
// interface (ctypes) by src/repro_torch/kernels/ski_grad.py. All tensors are
// contiguous fp32 (conv_tap_grad also takes bf16 inputs), and every sum runs
// in fp32 in a fixed order (no atomics), so both results are bitwise the
// same from run to run. The signal cotangent
// needs no kernel of its own: it is the forward's pass 2 of csrc/ski.cu with
// A transposed, the taps flipped and left mirrored (kernels/ski_vjp.py).
//
// conv_tap_grad  replaces src/repro/kernels/ski_grad.py _tap_grad_kernel /
//   _tap_grad_call_impl (conv_tap_grad_pallas):
//     df[c, k] = sum_{b, j} g[b, j, c] x[b, j - k + left, c],
//   g, x (b, n, d) with x zero outside [0, n), df (d, m), 0 <= left < m.
//   The TPU kernel carries the sum over sequential grid steps. Here blocks
//   run in no order, and d / 32 = 16 channel tiles alone cannot fill 132
//   SMs, so the rows of a tile are split over kTapSplit = 8 blocks.
//   Bound: g and x read once, df written once, 4 (2 b n d + d m) bytes: at
//   (8, 512, 512), m = 32, 16,842,752 bytes, 5.03 us at 3.35 TB/s; 2 b n d m
//   = 134 MFLOP, 2.0 us at 67 TFLOP/s fp32: bound by bytes.
//   Design: one launch. 8 blocks own a tile of 32 channels and 32 taps (a
//   tap pass; m > 32 takes several) and split its b n rows: each block
//   takes whole batch rows, or pieces of them when b < 8. A block streams
//   its rows in chunks of 128 through shared memory with cp.async, 16 bytes
//   (4 channels) a copy when d % 4 == 0, three chunks in flight: g into a
//   ring of chunk slots, x into a ring of 512 rows that carries the 31-row
//   halo from one chunk to the next, so each x row is read once a piece
//   (1.06x at the path, from 1.24x). A lane owns 4 channels and 8 taps;
//   each warp owns 16 rows of a chunk and runs its taps from a 15-row
//   register window of x with g from shared memory, summing in registers
//   over all of the block's chunks: one barrier a chunk. At the end the 8
//   warps' sums are added in warp order and written to the block's slot of
//   a workspace; the block that draws the tile's last ticket (an integer
//   atomic) adds the 8 blocks' sums in block order and stores df's rows
//   whole. No floating-point atomics: bitwise the same from run to run.
//   Every n >= 1 (n < m included), every m and every left in [0, m) run
//   here: the TPU wrapper's plain fallback for n < m has no counterpart.
//   Times on an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/ab_kernel.py
//   ski_grad, PERF.md), at the path: 0.0158-0.0161 ms, 11.9 us a launch in
//   a training step's profile. What holds it there (ablation builds): the
//   ticket's fence, atomic and read-back take about 2 us, and the loads run
//   at about two thirds of the bandwidth. A cluster of 8 blocks adding its
//   sums through distributed shared memory read 0.0229: the card placed a
//   cluster's blocks two to an SM, leaving SMs idle, and at one block an SM
//   it holds at most 15 such clusters at once (30 at two an SM,
//   cudaOccupancyMaxActiveClusters), fewer than the 16 tiles. Slower too:
//   16 blocks a tile (0.0172), chunks of 64 rows (0.0172), 2 chunks in
//   flight (0.0170), 512 threads (0.0168). The earlier design (PR 16:
//   b ceil(n / 128) blocks a tile wrote a (P, m, d) workspace, a second
//   kernel added it with a store strided by m) took 0.0213-0.0218; it kept
//   every tap in one pass, so at m = 400 it is faster (0.086 against
//   0.093).
//   conv_tap_grad_bf16 is the same body over bf16 g and x (the TPU kernel
//   takes bf16 and casts each tile to fp32 in VMEM; the port's Mamba conv
//   backward launches it): the rings keep g and x as bf16 (57,344 bytes of
//   shared memory a block, half the fp32 rings), a 16-byte copy moves 8
//   channels, and each quad is widened to fp32 exactly where a lane reads
//   it, so the sums are the fp32 instance's in its order. Bound: 2 (2 b n
//   d) + 4 d m bytes: at Mamba's conv (8, 2048, 5376), m = 4, 352,407,552
//   bytes, 0.1052 ms at 3.35 TB/s; 2 b n d m = 0.70 GFLOP, 0.0105 ms at 67
//   TFLOP/s: bound by bytes. A tap pass computes kTT = 32 taps whatever m
//   is, so at m = 4 seven eighths of its FMAs (5.6 GFLOP in all, 0.084 ms
//   at the fp32 peak) are thrown away: the first cut if it is slow.
//
// gram_grad  replaces src/repro/kernels/ski_grad.py _gram_grad_kernel /
//   _gram_grad_call (gram_grad_pallas):
//     dA[c, s, t] = sum_b gz[b, s, c] z[b, t, c],
//   gz, z (b, r, d), dA (d, r, r).
//   Bound: 4 (2 b r d + d r^2) bytes: at b = 8, r = 64, d = 512, 10,485,760
//   bytes, 3.13 us at 3.35 TB/s, four fifths of it the write of dA (at
//   r = 181, d = 512 and r = 512, d = 64, where dA is 67 MB: 0.0218 and
//   0.0207 ms); 2 b d r^2 = 34 MFLOP, 0.5 us at 67 TFLOP/s: bound by bytes.
//   Design: the write path first. An item is 4 channels (one 16-byte copy
//   of a row of gz or z) x 64 rows s x 64 columns t of dA: at r = 64 a
//   block's item is its 4 channels' whole panels, so every gz and z byte is
//   read from device memory once. One block an SM walks the items (beyond
//   r = 64 an item's gz and z tiles are read by its neighbours too, from
//   L2). A step stages 8 batch rows of the item's gz and z tiles by
//   cp.async, three steps in flight. A thread keeps 4 channels x 4 rows s x
//   4 columns t: per batch row eight 16-byte shared loads (z's rows
//   swizzled, conflict-free) and 64 fmaf; it stores the item as soon as its
//   last batch row is in, in 16-byte stores of 4 consecutive t when r % 4
//   == 0 (a warp's store is two whole 256-byte row pieces), else in 4-byte
//   stores at columns tq + 16 j (64 consecutive bytes a half warp). Each dA
//   element is fmaf over b = 0..b-1 from 0, 8 batch rows a step (rows past
//   b add exact zeros), the earlier kernel's chain, so dA is its dA bit for
//   bit. Times on an H100 (as above): 0.0109-0.0111 ms at the path (6.6 us
//   in a training step), 0.0419-0.0424 at r = 181, d = 512 and 0.0351 at
//   r = 512, d = 64. At the path the loads and the stores of a block run one
//   after the other (without the stores 0.0086, without the loads 0.0090);
//   at the ceilings an item's loads and sums take as long as its stores and
//   do not overlap them. Slower: items of 32 rows s, 128-thread blocks
//   three an SM, two 256-thread blocks an SM (128 registers). The earlier
//   design (PR 16: a block of 8 channels x 8 rows s x 64 columns, z gathered
//   by all 8 s-tiles of a channel group in 4-byte loads, scalar stores at
//   the end) took 0.0182-0.0183 ms at the path, 0.0967 and 0.0755 at the
//   ceilings; a first version that staged one batch row at a time 0.0203.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // both kernels: 8 warps
constexpr int kWarps = kThreads / 32;

constexpr int kTapSplit = 8;        // conv_tap_grad: blocks a tile,
constexpr int kTC = 32;             // channels of a tile,
constexpr int kTQ = kTC / 4;        // 16-byte quads of a tile row,
constexpr int kTT = 32;             // taps of a tap pass,
constexpr int kTK = 8;              // taps of a lane (a tap group),
constexpr int kTG = kTT / kTK;      // tap groups of a warp,
constexpr int kChunk = 128;         // rows of a chunk,
constexpr int kWRows = kChunk / kWarps;  // rows of a warp in a chunk,
constexpr int kHalf = 8;            // rows of a register window,
constexpr int kHalo = kTT - 1;      // x rows a chunk reads before its first,
constexpr int kStages = 3;          // chunks in flight,
constexpr int kXRing = 512;         // rows of the x ring (a power of two),
constexpr int kMinPiece = 32;       // fewest rows of a piece of a batch row
static_assert(kTQ * kTG == 32, "a warp's lanes: 8 quads x 4 tap groups");
static_assert(kWRows % kHalf == 0, "a warp's rows in whole windows");
static_assert(kXRing >= kStages * (kChunk + kHalo),
              "the x ring holds every chunk in flight with its halo");
// dynamic shared memory of a conv_tap_grad block: the g and x rings in the
// element type (fp32 114,688 bytes, bf16 57,344)
template <typename T>
constexpr int tap_smem_bytes() {
  return (kStages * kChunk * kTC + kXRing * kTC) * static_cast<int>(sizeof(T));
}
static_assert(kTT * kTC % kThreads == 0, "the tile's sums, whole per thread");
constexpr int kMaxTickets = 1 << 16;  // tiles x tap passes of a launch

constexpr int kGThreads = 256;      // gram_grad block: 8 warps,
constexpr int kGC = 4;              // item: channels,
constexpr int kGS = 64;             // rows s,
constexpr int kGT = 64;             // columns t,
constexpr int kGB = 8;              // batch rows a step,
constexpr int kGSR = 4;             // rows s of a thread (x 4 columns t),
constexpr int kGStages = 3;         // steps in flight,
constexpr int kGBlocksPerSM = 1;
static_assert(kGThreads == (kGS / kGSR) * (kGT / 4),
              "a thread takes kGSR rows s x 4 columns t");
static_assert(kGB * kGS % kGThreads == 0 && kGB * kGT % kGThreads == 0,
              "a thread copies whole rows of the gz and z tiles a step");
static_assert(kGStages * kGB * (kGS + kGT) * kGC * 4 <= 48 * 1024,
              "the stages fit in static shared memory");

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
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst),
               "l"(src), "r"(nbytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// bf16 values as their 16 bits: a bf16 is the high half of the fp32 of the
// same value, so widening is a shift, exact (no cuda_bf16.h needed).
using bf16_t = unsigned short;

// Channels of one 16-byte copy: 4 fp32, 8 bf16.
template <typename T>
constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));

// One channel into shared memory, zero when !valid (src is then not read):
// fp32 by a 4-byte cp.async; bf16 by a plain load and store (cp.async has
// no 2-byte form; the slot written is free, and the next __syncthreads
// publishes it as it publishes the copies).
__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void copy_one(bf16_t* dst, const bf16_t* src,
                                         bool valid) {
  *dst = valid ? *src : static_cast<bf16_t>(0);
}

// kPer16<T> consecutive channels c, c+1, ... of one row into shared memory:
// one 16-byte copy (kVec: d % kPer16<T> == 0, 16-byte aligned), else one
// copy a channel, each channel past d zero-filled; a row that is not `ok`
// is zero.
template <bool kVec, typename T>
__device__ __forceinline__ void copy_vec(T* dst, const T* base, const T* row,
                                         long long c, long long d, bool ok) {
  if (kVec) {
    cp_async16(dst, ok && c < d ? row + c : base, ok && c < d);
  } else {
#pragma unroll
    for (int u = 0; u < kPer16<T>; ++u) {
      const bool v = ok && c + u < d;
      copy_one(dst + u, v ? row + c + u : base, v);
    }
  }
}

// Four consecutive channels from shared memory, widened to fp32 (a bf16
// quad is one 8-byte load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

// ---------------------------------------------------------- conv_tap_grad
// One ticket for each (channel tile, tap pass): the count of the tile's
// blocks that have written their sums. A module variable, so each device
// has its own, zero when the module loads there; the block that draws the
// last ticket sets it back to 0. Launches on one device therefore must not
// overlap in time (the port launches on the current stream, in order).
__device__ unsigned int g_tap_tickets[kMaxTickets];

// A block's rows: pieces of batch rows, piece s of the tile's b * spr taken
// by block s % kTapSplit. Piece s is rows [q len, min(n, (q + 1) len)) of
// batch row s / spr, q = s % spr, streamed in chunks of kChunk rows.
struct TapCursor {
  long long piece, bi, j0;   // the piece, its batch row and first row
  long long rows;            // its rows
  long long chunk;           // the chunk of the piece
  long long seq;             // the block's chunk count before this one
  long long xpos;            // ring row of the piece's x window row 0
};

__device__ __forceinline__ void tap_piece(TapCursor& t, long long pieces,
                                          long long spr, long long len,
                                          long long n) {
  // skip empty pieces (the last piece of a batch row can be empty)
  for (; t.piece < pieces; t.piece += kTapSplit) {
    t.bi = t.piece / spr;
    t.j0 = (t.piece - t.bi * spr) * len;
    t.rows = n - t.j0 < len ? n - t.j0 : len;
    if (t.rows > 0) return;
  }
}

__device__ __forceinline__ void tap_next(TapCursor& t, long long pieces,
                                         long long spr, long long len,
                                         long long n) {
  ++t.seq;
  if (++t.chunk * kChunk < t.rows) return;
  // the next piece's window starts past this one's last row
  t.xpos += t.chunk * kChunk + kHalo;
  t.chunk = 0;
  t.piece += kTapSplit;
  tap_piece(t, pieces, spr, len, n);
}

// Requests one chunk: its g rows into ring slot seq % kStages, and the x
// rows it adds to the ring (its whole window, halo included, for a piece's
// first chunk). A piece's x row with window index i (x row j0 - k0 - kHalo
// + left + i) sits at ring row (xpos + i) mod kXRing: the pieces' windows
// follow each other in the ring, so no chunk in flight overwrites another's
// rows (at most kStages windows of kChunk + kHalo rows).
template <bool kVec, typename T>
__device__ __forceinline__ void tap_load(T* gring, T* xring,
                                         const TapCursor& t,
                                         const T* __restrict__ g,
                                         const T* __restrict__ x,
                                         long long n, long long d,
                                         long long c0, int k0, int left) {
  constexpr int kV = kPer16<T>;            // channels of a copy,
  constexpr int kTV = kTC / kV;            // copies of a tile row
  const long long r0 = t.chunk * kChunk;   // the chunk's first row in the piece
  T* gs = gring + (t.seq % kStages) * (kChunk * kTC);
  const T* gb = g + t.bi * n * d;
  const T* xb = x + t.bi * n * d;
  for (int e = threadIdx.x; e < kChunk * kTV; e += kThreads) {
    const int row = e / kTV, q = e % kTV;
    const long long j = t.j0 + r0 + row;
    copy_vec<kVec>(gs + row * kTC + kV * q, g, gb + j * d, c0 + kV * q, d,
                   r0 + row < t.rows);
  }
  const long long lo = t.chunk == 0 ? 0 : r0 + kHalo;
  const long long hi = r0 + kChunk + kHalo;
  const long long xi0 = t.j0 - k0 - kHalo + left;
  for (int e = threadIdx.x; e < (hi - lo) * kTV; e += kThreads) {
    const long long w = lo + e / kTV;
    const int q = e % kTV;
    const long long i = xi0 + w;
    const int slot = (int)((t.xpos + w) & (kXRing - 1));
    copy_vec<kVec>(xring + slot * kTC + kV * q, x, xb + i * d, c0 + kV * q, d,
                   i >= 0 && i < n);
  }
}

// Grid (kTapSplit, channel tiles, tap passes); dynamic shared memory
// tap_smem_bytes<T>(); part: kTapSplit (tile, pass) sums of kTT x kTC.
// T is float or bf16_t: the rings hold g and x as they are stored, each
// quad widened to fp32 where it is read, and every sum is fp32 in the same
// order for both.
template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    conv_tap_grad_kernel(const T* __restrict__ g,
                         const T* __restrict__ x, float* __restrict__ part,
                         float* __restrict__ df, long long b, long long n,
                         long long d, int m, int left, long long spr,
                         long long len) {
  static_assert(kWarps * kTT * kTC * sizeof(float)
                    <= kXRing * kTC * sizeof(T),
                "the warps' sums fit in the x ring");
  static_assert(kTT * (kTC + 1) * sizeof(float)
                    <= kStages * kChunk * kTC * sizeof(T),
                "the tile's sum fits in the g ring");
  extern __shared__ __align__(16) unsigned char tap_smem[];
  __shared__ bool last;
  T* gring = reinterpret_cast<T*>(tap_smem);    // [kStages][kChunk][kTC]
  T* xring = gring + kStages * kChunk * kTC;     // [kXRing][kTC]
  const int rank = (int)blockIdx.x;
  const long long c0 = (long long)blockIdx.y * kTC;
  const int k0 = (int)blockIdx.z * kTT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = lane % kTQ, tg = lane / kTQ;   // 4 channels, 8 taps
  const long long pieces = b * spr;

  float4 acc[kTK];
#pragma unroll
  for (int kk = 0; kk < kTK; ++kk) acc[kk] = make_float4(0.f, 0.f, 0.f, 0.f);

  TapCursor ld{rank, 0, 0, 0, 0, 0, 0};
  tap_piece(ld, pieces, spr, len, n);
  TapCursor cur = ld;
  // the first kStages - 1 chunks in flight (empty groups past the end)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld.piece < pieces) {
      tap_load<kVec, T>(gring, xring, ld, g, x, n, d, c0, k0, left);
      tap_next(ld, pieces, spr, len, n);
    }
    cp_async_commit();
  }
  while (cur.piece < pieces) {
    cp_async_wait<kStages - 2>();   // this chunk has landed
    __syncthreads();                // for every thread; slot seq - 1 is free
    if (ld.piece < pieces) {
      tap_load<kVec, T>(gring, xring, ld, g, x, n, d, c0, k0, left);
      tap_next(ld, pieces, spr, len, n);
    }
    cp_async_commit();
    const T* gs = gring + (cur.seq % kStages) * (kChunk * kTC) + 4 * cq;
    // row r0 + jj (jj = warp rows + h + q) with tap k0 + kTK tg + kk reads
    // window index r0 + jj - kTK tg - kk + kHalo: window element q + kTK-1-kk
    // from window base r0 + warp rows + h + kHalo - (kTK - 1) - kTK tg
    const long long wb0 = cur.xpos + cur.chunk * kChunk + warp * kWRows
                          + kHalo - (kTK - 1) - kTK * tg;
#pragma unroll
    for (int h = 0; h < kWRows; h += kHalf) {
      float4 xw[kHalf + kTK - 1];
#pragma unroll
      for (int e = 0; e < kHalf + kTK - 1; ++e) {
        const int slot = (int)((wb0 + h + e) & (kXRing - 1));
        xw[e] = load4(xring + slot * kTC + 4 * cq);
      }
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const float4 gv = load4(gs + (warp * kWRows + h + q) * kTC);
#pragma unroll
        for (int kk = 0; kk < kTK; ++kk) {
          const float4 xv = xw[q + kTK - 1 - kk];
          acc[kk].x = fmaf(gv.x, xv.x, acc[kk].x);
          acc[kk].y = fmaf(gv.y, xv.y, acc[kk].y);
          acc[kk].z = fmaf(gv.z, xv.z, acc[kk].z);
          acc[kk].w = fmaf(gv.w, xv.w, acc[kk].w);
        }
      }
    }
    tap_next(cur, pieces, spr, len, n);
  }
  cp_async_wait<0>();
  __syncthreads();                  // every warp is done with the rings
  // the warps' sums, [warp][tap][channel], added in warp order
  float* red = reinterpret_cast<float*>(xring);
#pragma unroll
  for (int kk = 0; kk < kTK; ++kk)
    *reinterpret_cast<float4*>(
        red + ((warp * kTT) + kTK * tg + kk) * kTC + 4 * cq) = acc[kk];
  __syncthreads();
  // this block's sums, [tap][channel], into its slot of the workspace
  const unsigned tile = blockIdx.z * gridDim.y + blockIdx.y;
  float* sums = part + (long long)tile * kTapSplit * (kTT * kTC);
  for (int o = threadIdx.x; o < kTT * kTC; o += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kTT * kTC + o];
    sums[rank * (kTT * kTC) + o] = s;
  }
  __threadfence();                  // the sums are seen before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&g_tap_tickets[tile], 1u) == kTapSplit - 1;
  __syncthreads();
  if (!last) return;
  // the tile's last block: the kTapSplit blocks' sums in block order, then
  // df's rows (channel-major) through a padded tile in shared memory
  __threadfence();
  float* out = reinterpret_cast<float*>(gring);   // [tap][kTC + 1]
  float v[kTT * kTC / kThreads][kTapSplit];
#pragma unroll
  for (int u = 0; u < kTT * kTC / kThreads; ++u)
#pragma unroll
    for (int p = 0; p < kTapSplit; ++p)
      v[u][p] = __ldcg(sums + p * kTT * kTC + threadIdx.x + u * kThreads);
#pragma unroll
  for (int u = 0; u < kTT * kTC / kThreads; ++u) {
    const int o = threadIdx.x + u * kThreads;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kTapSplit; ++p) s += v[u][p];
    out[(o / kTC) * (kTC + 1) + o % kTC] = s;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kTT * kTC; o += kThreads) {
    const int cl = o / kTT, kt = o % kTT;
    const long long c = c0 + cl;
    const int k = k0 + kt;
    if (c < d && k < m) df[c * m + k] = out[kt * (kTC + 1) + cl];
  }
  if (threadIdx.x == 0) g_tap_tickets[tile] = 0u;
}

// -------------------------------------------------------------- gram_grad
// An item: channels 4 cg.., rows s 64 st.., columns t 64 tt..; a step: 8
// batch rows 8 bc.. of it. z's tile row t sits at row swz(t) in shared
// memory, so that the 8 lanes of a quarter warp, reading rows 4 tq + j,
// hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int swz(int t) { return t ^ ((t >> 3) & 3); }

// Column j (0..3) of a thread's 4 in its item: 4 consecutive columns for
// 16-byte stores (kVecOut), else columns tq + 16 j, so that each 4-byte
// store of a half warp covers 64 consecutive bytes of a row.
template <bool kVecOut>
__device__ __forceinline__ int gram_col(int tq, int j) {
  return kVecOut ? 4 * tq + j : tq + (kGT / 4) * j;
}

struct GramStep {
  long long cg, st, tt;
  long long bc;
};

__device__ __forceinline__ GramStep gram_step(long long step, long long nb,
                                              long long nst, long long ntt) {
  const long long item = blockIdx.x + (step / nb) * (long long)gridDim.x;
  GramStep s;
  s.bc = step % nb;
  s.cg = item / (nst * ntt);
  const long long rem = item - s.cg * nst * ntt;
  s.st = rem / ntt;
  s.tt = rem - s.st * ntt;
  return s;
}

template <bool kVec>
__device__ __forceinline__ void gram_load(float* gs, float* zs,
                                          const GramStep& s,
                                          const float* __restrict__ gz,
                                          const float* __restrict__ z,
                                          long long b, long long r,
                                          long long d) {
  const long long c = s.cg * kGC;
#pragma unroll
  for (int u = 0; u < kGB * kGS / kGThreads; ++u) {
    const int e = threadIdx.x + u * kGThreads;
    const int bb = e / kGS, row = e % kGS;
    const long long bi = s.bc * kGB + bb, si = s.st * kGS + row;
    copy_vec<kVec>(gs + (bb * kGS + row) * kGC, gz, gz + (bi * r + si) * d,
                    c, d, bi < b && si < r);
  }
#pragma unroll
  for (int u = 0; u < kGB * kGT / kGThreads; ++u) {
    const int e = threadIdx.x + u * kGThreads;
    const int bb = e / kGT, row = e % kGT;
    const long long bi = s.bc * kGB + bb, ti = s.tt * kGT + row;
    copy_vec<kVec>(zs + (bb * kGT + swz(row)) * kGC, z,
                    z + (bi * r + ti) * d, c, d, bi < b && ti < r);
  }
}

// Grid: at most kGBlocksPerSM blocks an SM, block i taking items i, i +
// gridDim.x, ...; kVecIn: 16-byte copies (d % 4 == 0, aligned); kVecOut:
// 16-byte stores (r % 4 == 0, aligned).
template <bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kGThreads, kGBlocksPerSM)
    gram_grad_kernel(const float* __restrict__ gz,
                     const float* __restrict__ z, float* __restrict__ da,
                     long long b, long long r, long long d, long long items,
                     long long nst, long long ntt) {
  __shared__ __align__(16) float gs[kGStages][kGB * kGS * kGC];
  __shared__ __align__(16) float zs[kGStages][kGB * kGT * kGC];
  const long long nb = (b + kGB - 1) / kGB;
  const long long mine =
      blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * nb;
  const int tq = threadIdx.x % (kGT / 4), sq = threadIdx.x / (kGT / 4);
  float acc[kGC][kGSR][4];          // [channel][row s][column t]
#pragma unroll
  for (int c = 0; c < kGC; ++c)
#pragma unroll
    for (int i = 0; i < kGSR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.f;
  // the first kGStages - 1 steps in flight (empty groups past the end)
#pragma unroll
  for (int st = 0; st < kGStages - 1; ++st) {
    if (st < steps)
      gram_load<kVecIn>(gs[st], zs[st], gram_step(st, nb, nst, ntt), gz, z,
                        b, r, d);
    cp_async_commit();
  }
  for (long long st = 0; st < steps; ++st) {
    cp_async_wait<kGStages - 2>();  // this step has landed
    __syncthreads();                // for every thread; stage st - 1 is free
    const long long next = st + kGStages - 1;
    if (next < steps)
      gram_load<kVecIn>(gs[next % kGStages], zs[next % kGStages],
                        gram_step(next, nb, nst, ntt), gz, z, b, r, d);
    cp_async_commit();
    const int cur = (int)(st % kGStages);
    // the step's batch rows in order (rows past b add exact zeros)
#pragma unroll
    for (int bb = 0; bb < kGB; ++bb) {
      float4 gv[kGSR], zv[4];
#pragma unroll
      for (int i = 0; i < kGSR; ++i)
        gv[i] = *reinterpret_cast<const float4*>(
            &gs[cur][(bb * kGS + kGSR * sq + i) * kGC]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        zv[j] = *reinterpret_cast<const float4*>(
            &zs[cur][(bb * kGT + swz(gram_col<kVecOut>(tq, j))) * kGC]);
#pragma unroll
      for (int i = 0; i < kGSR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][i][j] = fmaf(gv[i].x, zv[j].x, acc[0][i][j]);
          acc[1][i][j] = fmaf(gv[i].y, zv[j].y, acc[1][i][j]);
          acc[2][i][j] = fmaf(gv[i].z, zv[j].z, acc[2][i][j]);
          acc[3][i][j] = fmaf(gv[i].w, zv[j].w, acc[3][i][j]);
        }
    }
    const GramStep s = gram_step(st, nb, nst, ntt);
    if (s.bc == nb - 1) {           // the item's last batch rows: store it
      const long long t0 = s.tt * kGT;
#pragma unroll
      for (int c = 0; c < kGC; ++c) {
        const long long ch = s.cg * kGC + c;
#pragma unroll
        for (int i = 0; i < kGSR; ++i) {
          const long long si = s.st * kGS + kGSR * sq + i;
          if (ch < d && si < r) {
            float* dst = da + (ch * r + si) * r + t0;
            if (kVecOut) {
              if (t0 + 4 * tq < r)
                *reinterpret_cast<float4*>(dst + 4 * tq) = make_float4(
                    acc[c][i][0], acc[c][i][1], acc[c][i][2], acc[c][i][3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int col = gram_col<false>(tq, j);
                if (t0 + col < r) dst[col] = acc[c][i][j];
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][i][j] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Pieces a batch row is cut into for conv_tap_grad: one when b fills the
// tile's kTapSplit blocks, else enough for each block to take one, but at
// most ceil(n / kMinPiece).
long long conv_tap_grad_pieces(long long b, long long n) {
  const long long want = (kTapSplit + b - 1) / b;
  const long long most = (n + kMinPiece - 1) / kMinPiece;
  const long long p = want < most ? want : most;
  return p < 1 ? 1 : p;
}

// One conv_tap_grad launch over g and x in T (float or bf16_t): the 16-byte
// instance when d is a multiple of a copy's channels and both are aligned.
template <typename T>
int launch_conv_tap_grad(const T* g, const T* x, void* part, void* df,
                         long long b, long long n, long long d, long long m,
                         long long left, void* stream) {
  const long long tiles = (d + kTC - 1) / kTC;
  const long long passes = (m + kTT - 1) / kTT;
  if (tiles > 65535 || passes > 65535 || tiles * passes > kMaxTickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long spr = conv_tap_grad_pieces(b, n);
  const long long len = (n + spr - 1) / spr;
  const bool vec = d % kPer16<T> == 0 && aligned16(g) && aligned16(x);
  void (*kernel)(const T*, const T*, float*, float*, long long, long long,
                 long long, int, int, long long, long long) =
      vec ? conv_tap_grad_kernel<true, T> : conv_tap_grad_kernel<false, T>;
  const int smem = tap_smem_bytes<T>();
  // set on the current device at each launch: no per-process state
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(kTapSplit, (unsigned)tiles, (unsigned)passes);
  kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      g, x, static_cast<float*>(part), static_cast<float*>(df), b, n, d,
      (int)m, (int)left, spr, len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of the conv_tap_grad workspace: kTapSplit block sums of kTT x kTC
// for each (channel tile, tap pass).
long long conv_tap_grad_workspace_floats(long long b, long long n,
                                         long long d, long long m) {
  (void)b, (void)n;
  return (d + kTC - 1) / kTC * ((m + kTT - 1) / kTT) * kTapSplit * kTT * kTC;
}

// g, x: (b, n, d) in T; part: conv_tap_grad_workspace_floats(b, n, d, m)
// floats; df: (d, m) fp32; contiguous on the device; 0 <= left < m. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue when the
// grid would exceed its bounds or the tickets.
int conv_tap_grad_f32(const void* g, const void* x, void* part, void* df,
                      long long b, long long n, long long d, long long m,
                      long long left, void* stream) {
  return launch_conv_tap_grad(static_cast<const float*>(g),
                              static_cast<const float*>(x), part, df, b, n, d,
                              m, left, stream);
}

// The same sums over bf16 g and x (each value widened to fp32 exactly where
// it is read), df fp32: the instance of the JAX kernel's bf16 inputs.
int conv_tap_grad_bf16(const void* g, const void* x, void* part, void* df,
                       long long b, long long n, long long d, long long m,
                       long long left, void* stream) {
  return launch_conv_tap_grad(static_cast<const bf16_t*>(g),
                              static_cast<const bf16_t*>(x), part, df, b, n,
                              d, m, left, stream);
}

// Blocks of each kernel an SM holds (the 16-byte fp32 instances), -1 on
// error.
int conv_tap_grad_blocks_per_sm() {
  int blocks = 0;
  const int smem = tap_smem_bytes<float>();
  if (cudaFuncSetAttribute(conv_tap_grad_kernel<true, float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, conv_tap_grad_kernel<true, float>, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

int gram_grad_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, gram_grad_kernel<true, true>, kGThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// gz, z: (b, r, d); da: (d, r, r); contiguous fp32 on the device. Returns
// cudaGetLastError() after the launch.
int gram_grad_f32(const void* gz, const void* z, void* da, long long b,
                  long long r, long long d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long nst = (r + kGS - 1) / kGS, ntt = (r + kGT - 1) / kGT;
  const long long items = (d + kGC - 1) / kGC * nst * ntt;
  const long long most = (long long)sms * kGBlocksPerSM;
  const unsigned grid = (unsigned)(items < most ? items : most);
  const bool vin = d % 4 == 0 && aligned16(gz) && aligned16(z);
  const bool vout = r % 4 == 0 && aligned16(da);
  void (*kernel)(const float*, const float*, float*, long long, long long,
                 long long, long long, long long, long long) =
      vin ? (vout ? gram_grad_kernel<true, true>
                  : gram_grad_kernel<true, false>)
          : (vout ? gram_grad_kernel<false, true>
                  : gram_grad_kernel<false, false>);
  kernel<<<grid, kGThreads, 0, s>>>(
      static_cast<const float*>(gz), static_cast<const float*>(z),
      static_cast<float*>(da), b, r, d, items, nst, ntt);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
