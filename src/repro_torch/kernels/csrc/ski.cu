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
// Every kernel here also takes the signal (x, z, y) in bf16 (the *_bf16
// entries, the JAX kernels' bf16 tiles): each value is widened to fp32
// exactly where it is read, every sum runs in fp32 as in the fp32
// instance, and an output is rounded to bf16 once, at its store. A, its
// coefficients and f stay fp32 (the wrapper widens bf16 ones, exactly).
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
//   bound by instruction issue. At the path shape it takes 10.0-10.5 us,
//   about 4 us above the ~6 us any launch reads under chip_smoke's timer.
//   Tried and left out (tools/ab_kernel.py ski --time-only, NVIDIA H100
//   80GB HBM3, 700 W, PERF.md): one pass over a run of nodes, each x row
//   read once with 16-byte loads, the two nodes a row touches carried as
//   running sums and written when the walk passes them (the same sums in
//   the same order, bit for bit). Through a cp.async ring in shared memory
//   11.5-12.5 us; from registers, the hat rows shared by warp shuffles,
//   11.3-11.8 us (runs of 1, 2 or 4 nodes, 8-byte loads, 8 or 16 rows in
//   flight, the next rows loaded while the current are summed). This
//   kernel's 2048 blocks of 4-byte loads keep more loads in flight across
//   more warps than any of them.
//   interp_reduce_bf16 is the same body over bf16 x and z (the bf16 SKI
//   model's pass 1, and twice in its backward): 2-byte loads, each widened
//   to fp32, and z rounded once. Bound: 2 (b n d + b r d) bytes, 4,718,592
//   at the path, 1.41 us. On an H100 (NVIDIA H100 80GB HBM3, 700 W;
//   chip_smoke.py phase ski_bf16, tools/ab_kernel.py ski --only bf16)
//   0.0090-0.0095 ms at the path, one reading of 0.0165 on a busy host.
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
//   Design: a thread carries one channel quad (16-byte loads and stores when
//   d % 4 == 0 and z, y are 16-byte aligned; else one channel) down a span
//   of kExpandSpan = 4 rows. Each lane of a span's group divides for one
//   row (hat_row) and the group's lanes take the span's (lo, w_lo) by warp
//   shuffles: no shared memory, no barrier. Where the span touches at most
//   kExpandWindow = 3 node rows (h >= 1.5, all but r near n), each is read
//   once into registers before the first store; else (r = n) the thread
//   issues every row's pair before its first store. y goes out by __stcs
//   (st.global.cs: evict-first, y is never re-read here). Blocks of qx = 32
//   quads (fewer at narrow d) by sy spans, sy halved from 256 threads to 64
//   until every SM has kExpandWave = 4 blocks: at the path 1,024 blocks of
//   128 threads, one wave. One 32-bit division a thread, none in the store
//   loop. Each output is the same expression as before, so y keeps its
//   bits. Every n >= 2 and 2 <= r <= n, r = n and r = 2 included, runs
//   here: no fallback.
//   Times on an H100 (NVIDIA H100 80GB HBM3, 700.00 W; tools/ab_kernel.py
//   ski --time-only --only interp, PERF.md), ms_run (64 launches an event
//   pair, cold) at the path / r = 8 / r = n: 5.63-5.91 / 4.92-5.00 /
//   8.77-8.82 us; the earlier kernel (a block of 8 rows, 256 threads
//   sweeping their quads with a 64-bit index, each quad loading both of
//   its nodes, 4 dependent load-store steps a thread behind 8 divisions
//   and a barrier) 6.17-6.21 / 5.89-5.92 / 9.69-9.71. Writing the path's y
//   alone (y.zero_()) reads 4.70-4.82: that, not 2.82, is the floor under
//   this timing. Its ablations: a 32-bit index 0.2 us faster, stores with
//   no loads of z 5.20-5.22 at the path, the pair loaded once a thread
//   5.80. So the loads' latency ahead of the stores held it back, the
//   division little. Also timed: spans of 8 rows 5.49-5.76 / 4.72-4.78 /
//   8.95-8.99 but 0.2-0.6 us slower at the smallest smoke shapes (more
//   serial work a thread); 2 rows 6.34-6.40 at the path; plain stores in
//   place of __stcs 6.20 / 5.68-5.69.
//   interp_expand_bf16 is the same body over bf16 z and y (the unfused
//   route's last step in bf16, and InterpReduce's backward there): a lane
//   carries 8 channels (16-byte loads and stores; d % 8 == 0 and z, y
//   16-byte aligned), else 4 (8 bytes; d % 4 == 0, 8-byte aligned), else
//   one; each value is widened, y is the fp32 instance's expression, rounded
//   once. Bound: 2 (b r d + b n d) bytes, 4,718,592 at the unfused path
//   (z (8, 64, 512) -> y (8, 512, 512)), 1.41 us at 3.35 TB/s. On an H100
//   (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase ski_bf16_routes,
//   tools/ab_kernel.py ski --time-only --only bf16; PERF.md) 0.0072-0.0074
//   ms (one launch an event pair, about 6 us of it the timer), the fp32
//   instance 0.0082 beside it.
//
// ski_fused_pass2  replaces src/repro/kernels/ski_fused.py _fused_kernel /
//   _fused_call (ski_fused_pass2_pallas):
//     y[b, i, c] = sum_s W[i, s] z2[b, s, c] + sum_{k<m} f[c, k] x[b, i-k+left, c],
//     z2[b, s, c] = sum_t A[c, s, t] z[b, t, c],
//   x zero outside [0, n), one write of y. left is a runtime argument: the
//   forward uses 0 (causal) or m/2; the signal backward is this same kernel
//   with A^T (ski_fused_pass2_at_f32, which reads A transposed in place),
//   the taps flipped and left mirrored.
//   Bound: x, z, A, f read once and y written once: at (8, 512, 512), r = 64,
//   m = 32, 26,279,936 bytes, 7.84 us at 3.35 TB/s; 176 MFLOP (conv 134 M,
//   Gram 34 M, expand 8 M), 2.6 us at 67 TFLOP/s fp32: bound by bytes, at
//   every rank (2 b = 16 flops per 4-byte word of A). At the dense route's
//   ceilings A dominates: r = 181, d = 512, 25.9 us; r = 512, d = 64, 21.0.
//   Design: a block owns one tile of TN sequence rows (128; 64 or 32 when
//   fewer tiles would leave SMs without a block, dense_tile) and 8 batch
//   rows x 4 channels (fewer rows, more channels for a batch under 8), its
//   32 columns on a warp's lanes, 8 warps, 4 blocks a SM. It computes only
//   the bw rows of z2 its hat rows touch: the window starts at the node of
//   the tile's first row (hat_row's lo), clamped to r - bw, as
//   ski_windowed_pass2's does; bw is the most nodes one tile touches,
//   counted on the host with the same fp32 hat_row (dense_window). So the
//   tiles of a column group stage A about once: 4 tiles x 18 rows of A's 64
//   at the path, where the earlier kernel read all of A in each of the 2
//   blocks that shared a column group.
//   1. Every copy is requested up front with cp.async: A's window in chunks
//      of kt columns (kt up to 64: one chunk at the path) as
//      [channel][row][kt + 4], 16-byte copies when r % 4 == 0 (A^T, and
//      rows not 16-byte aligned: 4-byte copies, lanes along the contiguous
//      axis), zero past r, b and d; z's kt rows of the block's columns as
//      [channel][t][8];
//      the x tile with its conv halo, 16-byte copies of 4 channels.
//   2. The Gram runs chunk by chunk as the chunks land, while later chunks
//      and the x tile are in flight: a thread takes one channel and two
//      window rows for the 8 batch rows, reads 4 values of each row of A in
//      one 16-byte load (a warp's lanes on consecutive rows, conflict-free)
//      and z's 8 batch values of a column in two 16-byte broadcasts, 64
//      fmaf a step. Each z2 element sums t in increasing order with fmaf
//      from 0, carried between chunks in shared memory: the earlier
//      kernel's chain, so y is its y bit for bit.
//   3. conv_expand_store, the conv of the windowed kernels too (8 taps at a
//      time from a 23-row register window), and one store of y.
//   Every n >= 2, 2 <= r <= n and 0 <= left < m runs here, n < m and r = n
//   included: no fallback.
//   Times on an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/ab_kernel.py ski,
//   PERF.md), at the path / r = 181, d = 512 / r = 512, d = 64: this kernel
//   0.0303-0.0312 / 0.0995-0.0998 / 0.0636-0.0640 ms; in the backward's
//   orientation 0.0369-0.0372 / 0.1044-0.1047 / 0.1105-0.1109. Earlier
//   (every block of a column group read all of A, a thread a row of A from
//   device memory, scalar loads when r % 4 != 0): 0.0303-0.0316 /
//   0.348-0.352 / 0.252-0.254, and with its backward's transposed copy of
//   A 0.0415-0.0435 / 0.485 / 0.388; before that 32.4, 39.2 and 92.7 us at
//   the path. At the path this kernel is held back by its memory traffic,
//   not the Gram: without the Gram it takes 0.0263 ms, and the conv alone
//   (csrc/short_conv.cu, x and y only) 0.0152. Splitting the Gram over a
//   cluster of 8 blocks, so that x and y move in whole 128-byte lines,
//   took 0.0352.
//   ski_fused_pass2_bf16 and ski_fused_pass2_at_bf16 are the same body over
//   bf16 x, z and y (A and f fp32): the x tile stays bf16 in shared memory
//   (the first half of the fp32 tile's bytes, so the layout and the launch
//   are the fp32 instance's), moved by 8-byte cp.async copies of 4
//   channels (cp.async has no 2-byte form: the scalar path of d % 4 != 0
//   loads and stores each value); conv_expand_store widens each value as
//   it reads it into its register window. z is widened on its way into the
//   chunk buffers by plain loads, so the Gram reads fp32 as before, and y
//   is rounded once. Bound: 2 (2 b n d + b r d) + 4 (d r^2 + d m) bytes,
//   17,367,040 at the path, 5.18 us: A's fp32 8.39 MB stays. On an H100
//   (as above) 0.0388-0.0466 ms at the path, A^T 0.0466-0.0495, against
//   the fp32 instance's 0.0291-0.0312 and 0.0377-0.0382 in the same calls
//   (not measured, a likely cause: each thread waits on its plain z loads
//   before it issues the x tile's copies).
//   Loading z eight values at a time a thread before any store read
//   0.0486-0.0497 (A^T 0.0571-0.0590) against this version's 0.0388-0.0409
//   (0.0474-0.0495) in the same call, old/new/new/old: left out.
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
//
//   ski_windowed_pass2_bf16 and ski_expand_pass2_bf16 are the same bodies
//   over bf16 x, z (z2) and y; the coefficients and f stay fp32. The x tile
//   stays bf16 in the first half of the fp32 tile's bytes, as in the dense
//   bf16 pass 2 (8-byte cp.async copies of 4 channels). A bf16 value is a
//   TF32 value (8 significant bits of TF32's 11, the same exponent range),
//   so z's lo half is zero: the Gram stage takes z by 8-byte copies of the
//   kGramC = 4 channels into the first half of the raw z buffer, widens
//   them where the stage is split, and runs two TF32 products, hi.hi and
//   lo.hi, not three (the coefficients are still split); the zl buffer
//   stays in the layout unused, so the shared memory and the launch are
//   the fp32 instance's. ski_expand_pass2_bf16 widens its window of z2 by
//   plain loads, eight rows a thread in flight before their stores. y is
//   rounded once from the same fp32 sums. Bounds at (8, 512, 512), r = 512,
//   m = 32: windowed 14,743,552 bytes (4.40 us) and 2 x 2,147 MFLOP TF32
//   (8.68 us at 495 TFLOP/s): 8.68 us, by operations; expand 12,648,448
//   bytes, 3.78 us. On an H100 (as above; tools/ab_kernel.py, the taps
//   widened before the timed call) the windowed bf16 instance took 0.0800
//   ms in both runs of one call, beside the fp32 instance's 0.0658-0.0804
//   and a build with the three products' 0.0817-0.1019: it does not beat
//   fp32 (the copies, split, conv and store, most of the kernel's time,
//   take as many instructions and 32-byte sectors as in fp32; not
//   measured further). The expand bf16 instance 0.0266-0.0291, the fp32
//   one 0.0274-0.0290.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

// bf16 values as their 16 bits. A bf16 is the high half of the fp32 of the
// same value, so widening is a shift, exact; narrowing rounds to nearest
// even (__float2bfloat16_rn), as torch's .to(torch.bfloat16) rounds.
using bf16_t = unsigned short;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16_t from_f32<bf16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The fp32 instance of a templated kernel: its operands split into TF32
// halves, its copies the 4-byte and 16-byte cp.async forms.
template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// Four consecutive channels from shared memory as fp32: one 16-byte load
// (fp32) or one 8-byte load of four bf16 values, each widened (the first
// channel in the low half of the first word).
__device__ __forceinline__ void load_quad(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_quad(const bf16_t* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

constexpr int kReduceThreads = 128;
constexpr int kExpandThreads = 256;  // interp_expand threads a block, at most
constexpr int kExpandSpan = 4;   // rows of y an interp_expand thread stores
constexpr int kExpandWindow = 3; // node rows a span keeps in registers
constexpr int kExpandWave = 4;   // interp_expand blocks aimed at per SM
constexpr int kExpandMinThreads = 64;  // and threads a block, at least
constexpr int kLanes = 32;       // (batch row, channel) columns of a block
constexpr int kZ2Pitch = kLanes + 1;
constexpr int kMaxCB = 8;        // batch rows of a pass-2 block, at most
constexpr int kWarps = 8;        // pass-2 block: 8 warps, 256 threads
constexpr int kTN = 128;         // sequence rows per pass-2 tile
constexpr int kKB = 8;           // conv taps per register window
constexpr int kBlocksPerSM = 3;  // pass-2 blocks aimed at per SM
constexpr int kMaxSmem = 232448; // bytes a block may use (227 KB)
constexpr int kSmemPerSM = 233472;  // bytes a SM holds for its blocks
constexpr int kMaxDevices = 64;  // devices with their own pass-2 state
constexpr int kGramC = 4;        // channels of a ski_windowed_pass2 block
constexpr int kStageT = 128;     // z rows of a Gram stage
constexpr int kMaxMT = 9;        // window m-tiles of 16 rows, at most
constexpr int kWindowedBlocksPerSM = 2;   // ski_windowed_pass2 blocks a SM
constexpr int kZ2Batch = 8;      // bf16 z2 rows a thread loads at once
constexpr int kDenseBlocksPerSM = 4;      // ski_fused_pass2 blocks a SM

// The two taps of W's row i: node lo and weight w_lo (1 - w_lo on lo + 1).
__host__ __device__ __forceinline__ int hat_row(long long i, float hf,
                                                int r, float& w_lo) {
#ifdef __CUDA_ARCH__
  const float f = __fdiv_rn((float)i, hf);
#else
  const float f = (float)i / hf;          // IEEE division on the host too
#endif
  int lo = (int)floorf(f);
  lo = lo < 0 ? 0 : (lo > r - 2 ? r - 2 : lo);
  w_lo = fminf(fmaxf(1.f - (f - (float)lo), 0.f), 1.f);
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    interp_reduce_kernel(const T* __restrict__ x, T* __restrict__ z,
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
  const T* xb = x + bi * n * d + (c < d ? c : 0);
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
      for (int q = 0; q < cnt; ++q)
        acc = fmaf(ws[q], to_f32(xb[(base + q) * d]), acc);
    }
    __syncthreads();
  }
  if (c < d) z[(bi * r + j) * d + c] = from_f32<T>(acc);
}

// One hat row of y from its node pair, float or float4 lanes: the parent
// kernel's expression, so y keeps its bits.
__device__ __forceinline__ float expand_row(float wl, float a, float b) {
  const float wh = 1.f - wl;
  return wl * a + wh * b;
}

__device__ __forceinline__ float4 expand_row(float wl, float4 a, float4 b) {
  const float wh = 1.f - wl;
  float4 o;
  o.x = wl * a.x + wh * b.x;
  o.y = wl * a.y + wh * b.y;
  o.z = wl * a.z + wh * b.z;
  o.w = wl * a.w + wh * b.w;
  return o;
}

// bf16 lanes of 1, 4 (uint2) or 8 (uint4) channels: each value widened,
// the fp32 expression above, rounded once.
__device__ __forceinline__ bf16_t expand_row(float wl, bf16_t a, bf16_t b) {
  return from_f32<bf16_t>(expand_row(wl, to_f32(a), to_f32(b)));
}

// Two bf16 channels of one word, the first in the low half.
__device__ __forceinline__ unsigned expand_pair(float wl, unsigned a,
                                                unsigned b) {
  const float lo = expand_row(wl, __uint_as_float(a << 16),
                              __uint_as_float(b << 16));
  const float hi = expand_row(wl, __uint_as_float(a & 0xffff0000u),
                              __uint_as_float(b & 0xffff0000u));
  return static_cast<unsigned>(from_f32<bf16_t>(lo)) |
         (static_cast<unsigned>(from_f32<bf16_t>(hi)) << 16);
}

__device__ __forceinline__ uint2 expand_row(float wl, uint2 a, uint2 b) {
  return make_uint2(expand_pair(wl, a.x, b.x), expand_pair(wl, a.y, b.y));
}

__device__ __forceinline__ uint4 expand_row(float wl, uint4 a, uint4 b) {
  return make_uint4(expand_pair(wl, a.x, b.x), expand_pair(wl, a.y, b.y),
                    expand_pair(wl, a.z, b.z), expand_pair(wl, a.w, b.w));
}

// V is float4 (d % 4 == 0, z and y 16-byte aligned) or float; for bf16 z
// and y uint4 (8 channels), uint2 (4) or bf16_t; cols = d / (channels of
// V) lanes of V a row. Block (qx, sy): qx lanes of V along a row (a power
// of two, kExpandSpan <= qx <= 32) by sy spans of kExpandSpan rows;
// blockIdx.x = span block * slabs + slab, blockIdx.y the batch row.
template <typename V>
__global__ void __launch_bounds__(kExpandThreads)
    interp_expand_kernel(const V* __restrict__ z, V* __restrict__ y,
                         int n, int cols, int r, float hf, int slabs) {
  const int qx = blockDim.x, lane_x = threadIdx.x;
  const int sb = blockIdx.x / slabs;                 // 32-bit, once
  const int c = (blockIdx.x - sb * slabs) * qx + lane_x;
  const int i0 = (sb * blockDim.y + threadIdx.y) * kExpandSpan;
  const long long bi = blockIdx.y;
  // lane x of a span's group divides for row i0 + x % kExpandSpan (rows
  // past n repeat row n - 1); the group's lanes read the span's rows by
  // shuffles, so no lane waits on shared memory or a barrier
  int row = i0 + (lane_x & (kExpandSpan - 1));
  row = row < n ? row : n - 1;
  float w_row;
  const int lo_row = hat_row(row, hf, r, w_row);
  const int group = (threadIdx.y * qx) & 31;         // the group's first lane
  int lo[kExpandSpan];
  float wl[kExpandSpan];
#pragma unroll
  for (int j = 0; j < kExpandSpan; ++j) {
    lo[j] = __shfl_sync(0xffffffffu, lo_row, group + j);
    wl[j] = __shfl_sync(0xffffffffu, w_row, group + j);
  }
  if (c >= cols || i0 >= n) return;
  const V* zc = z + bi * r * cols + c;
  V* yc = y + (bi * n + i0) * cols + c;
  const int rows = n - i0 < kExpandSpan ? n - i0 : kExpandSpan;
  const int l0 = lo[0];
  if (lo[kExpandSpan - 1] - l0 < kExpandWindow - 1) {
    // the span's rows lie on at most kExpandWindow nodes: each node row is
    // read once, into registers, before the first store
    const int kn = lo[kExpandSpan - 1] - l0 + 2;
    V win[kExpandWindow];
    win[0] = __ldg(zc + (long long)l0 * cols);
#pragma unroll
    for (int k = 1; k < kExpandWindow; ++k)
      win[k] = k < kn ? __ldg(zc + (long long)(l0 + k) * cols) : win[k - 1];
#pragma unroll
    for (int j = 0; j < kExpandSpan; ++j) {
      if (j < rows) {
        const int k = lo[j] - l0;
        V a = win[0], b = win[1];
#pragma unroll
        for (int q = 1; q < kExpandWindow - 1; ++q)
          if (k == q) { a = win[q]; b = win[q + 1]; }
        __stcs(yc + (long long)j * cols, expand_row(wl[j], a, b));
      }
    }
    return;
  }
  // more nodes than the window (h below about 1.5, r near n): every
  // row's pair, all loads issued before the first store
  V a[kExpandSpan], b[kExpandSpan];
#pragma unroll
  for (int j = 0; j < kExpandSpan; ++j) {
    a[j] = __ldg(zc + (long long)lo[j] * cols);
    b[j] = __ldg(zc + (long long)(lo[j] + 1) * cols);
  }
#pragma unroll
  for (int j = 0; j < kExpandSpan; ++j)
    if (j < rows)
      __stcs(yc + (long long)j * cols, expand_row(wl[j], a[j], b[j]));
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

// Four consecutive channels global -> shared, zero-filling when !valid: fp32
// one 16-byte copy, bf16 one 8-byte copy (both ends aligned to its size).
__device__ __forceinline__ void cp_async_quad(float* dst, const float* src,
                                              bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void cp_async_quad(bf16_t* dst, const bf16_t* src,
                                              bool valid) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sdst),
               "l"(src), "r"(nbytes));
}

// One channel global -> shared, zero when !valid (src is then not read):
// fp32 by a 4-byte cp.async; bf16 by a plain load and store (cp.async has no
// 2-byte form; the next __syncthreads publishes it as it publishes the
// copies, and the slot it writes is free as the copy's would be).
__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void copy_one(bf16_t* dst, const bf16_t* src,
                                         bool valid) {
  *dst = valid ? *src : static_cast<bf16_t>(0);
}

// One z value into a fp32 Gram chunk slot, zero when !valid: fp32 by a
// 4-byte cp.async, bf16 widened by a plain load and store.
__device__ __forceinline__ void copy_widened(float* dst, const float* src,
                                             bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void copy_widened(float* dst, const bf16_t* src,
                                             bool valid) {
  *dst = valid ? to_f32(*src) : 0.f;
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

// Taps rounded up to whole register windows.
__host__ __device__ __forceinline__ int padded_taps(long long m) {
  return (int)((m + kKB - 1) / kKB * kKB);
}

// Request x rows [i0 - hl, i0 - hl + rows) of the block's 32 columns into
// the tile buffer xs ([rows][kLanes]); rows outside [0, n) and columns past
// b or d are zero-filled. vec16 (8 batch rows x 4 channels, d % 4 == 0, x
// aligned to 4 channels): one copy of 4 channels (16 bytes fp32, 8 bytes
// bf16) per (row, batch row); otherwise one channel per (row, column).
template <typename T>
__device__ __forceinline__ void load_tile(T* xs, const T* x, long long b0,
                                          long long c0, long long i0, int hl,
                                          int rows, long long b, long long n,
                                          long long d, int cb, bool vec16) {
  if (vec16) {
    for (int e = threadIdx.x; e < rows * kMaxCB; e += kLanes * kWarps) {
      const int q = e / kMaxCB;
      const int bl = e - q * kMaxCB;
      const long long i = i0 - hl + q;
      const bool ok = b0 + bl < b && i >= 0 && i < n;
      cp_async_quad(xs + q * kLanes + bl * 4,
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
    copy_one(xs + q * kLanes + lane, ok ? x + (bg * n + i) * d + c : x, ok);
  }
}

// The conv over a tile and the two-tap expansion, one store: output rows
// row0 .. row0 + RPT - 1 of the tile (row0 = warp * RPT) in column lane.
// xt is the tile with its halo ([TN + mp - 1][kLanes], tile row q holding x
// row i0 - (mp - 1 - left) + q), fs the taps ([mp][kLanes], zero past m),
// z2w the rows of z2 from node w0 on ([.][kZ2Pitch]), hlo / hw the tile
// rows' nodes and weights. Output row row0 + q with tap k reads tile row
// row0 + q - k + mp - 1; the kKB + RPT - 1 rows a block of kKB taps needs
// sit in registers, so each x value is read from shared memory once a block
// (a bf16 value widened as it is read); y is rounded to T at its store.
template <int RPT, typename T>
__device__ __forceinline__ void conv_expand_store(
    const T* xt, const float* fs, int mp, const float* z2w, int w0,
    const int* hlo, const float* hw, T* __restrict__ y, long long i0,
    long long n, long long d, long long bg, long long c, bool valid) {
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * RPT;
  float acc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
  for (int kb = 0; kb < mp; kb += kKB) {
    const T* xr = xt + (row0 + mp - kb - kKB) * kLanes + lane;
    float xw[RPT + kKB - 1];
#pragma unroll
    for (int e = 0; e < RPT + kKB - 1; ++e) xw[e] = to_f32(xr[e * kLanes]);
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
      y[(bg * n + i) * d + c] = from_f32<T>(low + acc[q]);
    }
  }
}

// Floats of one ski_fused_pass2 Gram chunk for kc channels, a window of bw
// rows and kt columns of A: z's kt rows of the block's columns as
// [kc][kt][kMaxCB] (batch rows innermost, padded to 8 with zeros), then
// A's window as [kc][bw][kt + 4] (the pitch keeps the 16-byte reads of a
// warp's consecutive rows on distinct banks).
__host__ __device__ __forceinline__ int dense_chunk_floats(int kc, int bw,
                                                           int kt) {
  return kc * kt * kMaxCB + kc * bw * (kt + 4);
}

// Request Gram chunk t0 .. t0 + kt - 1 into zc / ac: z[b0 + u, t, c0 + ch]
// as zc[ch][t - t0][u], and the window's rows s of A[c0 + ch] as
// ac[ch][s][t - t0], that is A[c, w0 + s, t] or, when a_t, A[c, t, w0 + s]
// (A^T read in place). A by 16-byte copies when a_vec16 (A's rows 16-byte
// aligned, not transposed), else 4-byte ones; zero past b, d and r and for
// batch rows u >= cb. A bf16 z is widened into zc (copy_widened). kc and
// kt are powers of two (kcl, ktl their logarithms): the index arithmetic is
// shifts and masks.
template <typename T>
__device__ __forceinline__ void load_dense_chunk(
    float* zc, float* ac, const T* z, const float* a, long long b0,
    long long c0, int w0, int t0, int kcl, int cb, int bw, int ktl, int r,
    long long b, long long d, bool a_vec16, bool a_t) {
  const int nt = kLanes * kWarps;
  const int kc = 1 << kcl, kt = 1 << ktl, ktp = kt + 4;
  // z: consecutive threads along the channels, which are contiguous in z
  for (int e = threadIdx.x; e < (kt * kMaxCB) << kcl; e += nt) {
    const int ch = e & (kc - 1), q = e >> kcl;      // q = t kMaxCB + u
    const int t = q >> 3, u = q & 7;
    const bool ok = u < cb && b0 + u < b && c0 + ch < d && t0 + t < r;
    copy_widened(zc + ((ch << ktl) + t) * kMaxCB + u,
                 ok ? z + ((b0 + u) * r + t0 + t) * d + c0 + ch : z, ok);
  }
  const long long rr = (long long)r * r;
  const float* ab = a + c0 * rr;
  if (a_vec16) {                       // kt / 4 copies of 16 bytes a row
    const int kql = ktl - 2;
    for (int e = threadIdx.x; e < (bw << kcl) << kql; e += nt) {
      const int row = e >> kql, t = (e & ((1 << kql) - 1)) << 2;
      const int ch = row / bw, s = row - ch * bw;       // row = ch bw + s
      const bool ok = c0 + ch < d && w0 + s < r && t0 + t < r;
      cp_async16(ac + row * ktp + t,
                 ok ? ab + ch * rr + (long long)(w0 + s) * r + t0 + t : a,
                 ok);
    }
  } else if (!a_t) {
    for (int e = threadIdx.x; e < (bw << kcl) << ktl; e += nt) {
      const int row = e >> ktl, t = e & (kt - 1);
      const int ch = row / bw, s = row - ch * bw;
      const bool ok = c0 + ch < d && w0 + s < r && t0 + t < r;
      cp_async4(ac + row * ktp + t,
                ok ? ab + ch * rr + (long long)(w0 + s) * r + t0 + t : a, ok);
    }
  } else {                             // a warp a (ch, t), its lanes along s:
    const int lane = threadIdx.x & 31; //   A^T's row is A's column
    for (int q = threadIdx.x >> 5; q < kc << ktl; q += kWarps) {
      const int ch = q >> ktl, t = q & (kt - 1);
      const bool row_ok = c0 + ch < d && t0 + t < r;
      const float* src = ab + ch * rr + (long long)(t0 + t) * r + w0;
      float* dst = ac + ch * bw * ktp + t;
      for (int s = lane; s < bw; s += 32) {
        const bool ok = row_ok && w0 + s < r;
        cp_async4(dst + s * ktp, ok ? src + s : a, ok);
      }
    }
  }
}

// One Gram chunk: z2w[s][u kc + ch] += sum_t ac[ch][s][t] zc[ch][t][u].
// A thread takes one channel ch and two window rows, s and s + ceil(bw/2),
// for the 8 batch rows: per 4 columns t it reads each row's 4 values of A
// in one 16-byte load (a warp's lanes on consecutive rows) and z's 8 batch
// values of each t in two 16-byte loads, the same for every lane of the
// channel (a broadcast), for 64 fmaf. t runs in increasing order and the
// sums carry over between chunks in z2w (first: from 0), so every z2
// element is one fmaf chain over t = 0 .. r-1, in the order the earlier
// kernel summed it.
__device__ __forceinline__ void dense_gram_chunk(const float* zc,
                                                 const float* ac, float* z2w,
                                                 int kc, int cb, int bw,
                                                 int kt, bool first) {
  const int half = (bw + 1) >> 1, ktp = kt + 4;
  for (int q = threadIdx.x; q < kc * half; q += kLanes * kWarps) {
    const int ch = q / half, s0 = q - ch * half, s1 = s0 + half;
    const bool two = s1 < bw;
    const float* a0 = ac + (ch * bw + s0) * ktp;
    const float* a1 = ac + (ch * bw + (two ? s1 : s0)) * ktp;
    const float* zr = zc + ch * kt * kMaxCB;
    float acc0[kMaxCB], acc1[kMaxCB];
#pragma unroll
    for (int u = 0; u < kMaxCB; ++u) {
      const bool keep = !first && u < cb;
      acc0[u] = keep ? z2w[s0 * kZ2Pitch + u * kc + ch] : 0.f;
      acc1[u] = keep && two ? z2w[s1 * kZ2Pitch + u * kc + ch] : 0.f;
    }
    for (int t = 0; t < kt; t += 4) {
      const float4 va = *reinterpret_cast<const float4*>(a0 + t);
      const float4 vb = *reinterpret_cast<const float4*>(a1 + t);
      const float av[4] = {va.x, va.y, va.z, va.w};
      const float bv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 zl =
            *reinterpret_cast<const float4*>(zr + (t + j) * kMaxCB);
        const float4 zh =
            *reinterpret_cast<const float4*>(zr + (t + j) * kMaxCB + 4);
        const float zv[kMaxCB] = {zl.x, zl.y, zl.z, zl.w,
                                  zh.x, zh.y, zh.z, zh.w};
#pragma unroll
        for (int u = 0; u < kMaxCB; ++u) {
          acc0[u] = fmaf(av[j], zv[u], acc0[u]);
          acc1[u] = fmaf(bv[j], zv[u], acc1[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxCB; ++u) {
      if (u < cb) {
        z2w[s0 * kZ2Pitch + u * kc + ch] = acc0[u];
        if (two) z2w[s1 * kZ2Pitch + u * kc + ch] = acc1[u];
      }
    }
  }
}

// One block: one tile of TN sequence rows (RPT = TN / kWarps a thread) and
// cb batch rows x kc = 32/cb channels, lane = row * kc + channel, as the
// windowed kernels. Its window of bw rows of z2 = A z starts at the node
// of the tile's first row (clamped to r - bw) and covers every node its
// hat rows touch (ski_fused_pass2_f32 sizes bw so). A's window streams
// through nbuf chunk buffers, kt columns at a time, beside z's kt rows;
// the x tile with its halo is requested with the first chunks, so every
// copy is in flight before the Gram starts. T is the signal's type (x, z,
// y: float or bf16_t); a bf16 x tile fills the first half of the fp32
// tile's bytes, so the layout is the same for both.
template <int TN, typename T>
__global__ void __launch_bounds__(kLanes * kWarps, kDenseBlocksPerSM)
    ski_dense_pass2_kernel(const T* __restrict__ x,
                           const T* __restrict__ z,
                           const float* __restrict__ a,
                           const float* __restrict__ filt,
                           T* __restrict__ y, long long b, long long n,
                           long long d, int r, int m, int left, float hf,
                           int cb, int bw, int kt, int nbuf, bool x_vec16,
                           bool a_vec16, bool a_t) {
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
  T* xs = reinterpret_cast<T*>(smem);   // [rows][kLanes]  x tile
  float* fs = smem + rows * kLanes;     // [mp][kLanes]    f[c, k]
  float* z2w = fs + mp * kLanes;        // [bw][kZ2Pitch]  z2[bg, w0 + j, c]
  float* hw = z2w + (bw * kZ2Pitch + 3) / 4 * 4;       // [TN] w_lo of rows
  int* hlo = reinterpret_cast<int*>(hw + TN);          // [TN] their nodes
  float* ring = reinterpret_cast<float*>(hlo + TN);    // nbuf Gram chunks
  const int chunk = dense_chunk_floats(kc, bw, kt);
  const int kcl = __ffs(kc) - 1, ktl = __ffs(kt) - 1;   // both powers of 2
  float wl0;
  int w0 = hat_row(i0, hf, r, wl0);
  const int w0_max = r > bw ? r - bw : 0;
  w0 = w0 < w0_max ? w0 : w0_max;
  const int nch = (r + kt - 1) / kt;
  // chunks in flight: all when they fit the ring, else all but one buffer
  const int ahead = nch <= nbuf ? nch : nbuf - 1;

  // 1. every copy requested up front: the first chunks (chunk j is cp.async
  //    group j) and, with the last of them, the x tile and its halo
  for (int j = 0; j < ahead; ++j) {
    float* zc = ring + j * chunk;
    load_dense_chunk(zc, zc + kc * kt * kMaxCB, z, a, b0, c0, w0, j * kt,
                     kcl, cb, bw, ktl, r, b, d, a_vec16, a_t);
    if (j == ahead - 1)
      load_tile(xs, x, b0, c0, i0, mp - 1 - left, rows, b, n, d, cb,
                x_vec16);
    cp_async_commit();
  }
  for (int k = warp; k < mp; k += kWarps)
    fs[k * kLanes + lane] = valid && k < m ? filt[c * m + k] : 0.f;
  if (threadIdx.x < TN) {
    float w_lo;
    hlo[threadIdx.x] = hat_row(i0 + threadIdx.x, hf, r, w_lo);
    hw[threadIdx.x] = w_lo;
  }

  // 2. the window of z2 = A z, chunk by chunk as they land
  for (int s = 0; s < nch; ++s) {
    cp_async_wait(ahead - 1);           // chunk s has landed
    __syncthreads();                    // ... for all; buffer s - 1 free
    if (s + ahead < nch) {
      float* zc = ring + ((s + ahead) % nbuf) * chunk;
      load_dense_chunk(zc, zc + kc * kt * kMaxCB, z, a, b0, c0, w0,
                       (s + ahead) * kt, kcl, cb, bw, ktl, r, b, d, a_vec16,
                       a_t);
    }
    cp_async_commit();                  // possibly empty: keeps the count
    const float* zc = ring + (s % nbuf) * chunk;
    dense_gram_chunk(zc, zc + kc * kt * kMaxCB, z2w, kc, cb, bw, kt, s == 0);
  }
  cp_async_wait(0);                     // the x tile
  __syncthreads();
  // 3. conv, expansion, one store
  conv_expand_store<TN / kWarps>(xs, fs, mp, z2w, w0, hlo, hw, y, i0, n, d,
                                 bg, c, valid);
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
// one copy of 4 channels, 16 bytes fp32 or 8 bytes bf16, when vec16; a bf16
// stage fills the first half of zr's bytes), and coefficients
// base .. base + span - 1 of its kGramC channels as cr[ch][e]; zero past r,
// b, d and outside [0, 2r - 1).
template <typename T>
__device__ __forceinline__ void load_gram_stage(
    float* zr, float* cr, const T* z, const float* coef, long long b0,
    long long c0, int t0, long long base, int span, int r, long long b,
    long long d, bool vec16) {
  T* zs = reinterpret_cast<T*>(zr);
  if (vec16) {
    for (int e = threadIdx.x; e < kStageT * kMaxCB; e += kLanes * kWarps) {
      const int t = e >> 3, u = e & 7;
      const bool ok = b0 + u < b && t0 + t < r;
      cp_async_quad(zs + 4 * e,
                    ok ? z + ((b0 + u) * r + t0 + t) * d + c0 : z, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kStageT * kLanes; e += kLanes * kWarps) {
      const int t = e >> 5, u = (e >> 2) & 7, ch = e & 3;
      const bool ok = b0 + u < b && c0 + ch < d && t0 + t < r;
      copy_one(zs + e, ok ? z + ((b0 + u) * r + t0 + t) * d + c0 + ch : z,
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
// lanes then read 32 consecutive words), the coefficients in place. A bf16
// z is widened here; it is a TF32 value, so hi = v and no lo is written.
template <typename T>
__device__ __forceinline__ void split_gram_stage(const float* zr,
                                                 const float* cr, float* zh,
                                                 float* zl, float* csh,
                                                 float* csl, int span) {
  for (int e = threadIdx.x; e < kStageT * kMaxCB; e += kLanes * kWarps) {
    float vs[kGramC];
    load_quad(reinterpret_cast<const T*>(zr) + 4 * e, vs);
#pragma unroll
    for (int ch = 0; ch < kGramC; ++ch) {
      if constexpr (kIsF32<T>) {
        const float hi = tf32_rna(vs[ch]);
        zh[ch * kStageT * kMaxCB + e] = hi;  // e = t * kMaxCB + batch row
        zl[ch * kStageT * kMaxCB + e] = tf32_rna(vs[ch] - hi);
      } else {
        zh[ch * kStageT * kMaxCB + e] = vs[ch];
      }
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
// a second, all into the same fp32 accumulators in a fixed order. Without
// kZLo (a bf16 z, whose lo half is zero) the hi.lo product is left out.
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
template <int MA, int NM, bool kZLo>
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
      if (kZLo && sweep == 0) {
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
// are split into TF32 halves once, for every warp (z in T, float or
// bf16_t; a bf16 z has no lo half, and its products are two).
template <int MT, typename T>
__device__ __forceinline__ void gram_window_tc(
    const T* __restrict__ z, const float* __restrict__ coef, float* z2w,
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
    split_gram_stage<T>(zr, cr, zh, zl, csh, csl, span);
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
      gram_stage_mma<MA, MA, kIsF32<T>>(acc, zhc, zlc, csh + ch * span,
                                        csl + ch * span, m0);
    else
      gram_stage_mma<MA, MB, kIsF32<T>>(acc, zhc, zlc, csh + ch * span,
                                        csl + ch * span, m0);
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
// window is copied (ski_expand_pass2; coef unused). T is the signal's
// type (x, z, y: float or bf16_t); a bf16 x tile fills the first half of
// the fp32 tile's bytes, so the layout is the same for both.
template <int TN, bool kBanded, int MT, typename T>
__global__ void __launch_bounds__(kLanes * kWarps,
                                  kBanded ? kWindowedBlocksPerSM
                                          : kBlocksPerSM)
    ski_window_pass2_kernel(const T* __restrict__ x,
                            const T* __restrict__ z,
                            const float* __restrict__ coef,
                            const float* __restrict__ filt,
                            T* __restrict__ y, long long b, long long n,
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
  T* xs = reinterpret_cast<T*>(smem);   // [rows][kLanes]  x tile (16-byte
                                        //   aligned: first)
  float* fs = smem + rows * kLanes;     // [mp][kLanes]    f[c, k]
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
  } else if constexpr (kIsF32<T>) {
    for (int j = warp; j < bw; j += kWarps) {
      const long long t = w0 + j;
      const bool ok = valid && t < r;
      cp_async4(z2w + j * kZ2Pitch + lane, ok ? z + (bg * r + t) * d + c : z,
                ok);
    }
  } else {
    // bf16 z2 widened by plain loads (cp.async has no 2-byte form), a
    // thread's kZ2Batch rows issued before any of their stores
    for (int j0 = warp; j0 < bw; j0 += kWarps * kZ2Batch) {
      float v[kZ2Batch];
#pragma unroll
      for (int k = 0; k < kZ2Batch; ++k) {
        const int j = j0 + k * kWarps;
        const long long t = w0 + j;
        const bool ok = valid && j < bw && t < r;
        v[k] = ok ? to_f32(__ldg(z + (bg * r + t) * d + c)) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kZ2Batch; ++k) {
        const int j = j0 + k * kWarps;
        if (j < bw) z2w[j * kZ2Pitch + lane] = v[k];
      }
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
    gram_window_tc<MT, T>(z, coef, z2w, stage, w0, bw, r, b, d, b0, c0,
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

template <int TN, bool kBanded, int MT, typename T>
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
    e = cudaFuncSetAttribute(ski_window_pass2_kernel<TN, kBanded, MT, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = smem;
  }
  ski_window_pass2_kernel<TN, kBanded, MT, T>
      <<<grid, kLanes * kWarps, (size_t)smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(z),
          static_cast<const float*>(coef), static_cast<const float*>(filt),
          static_cast<T*>(y), b, n, d, (int)r, (int)m, (int)left, hf, cb,
          (int)bw, x_vec16, z_vec16);
  return static_cast<int>(cudaGetLastError());
}

// The windowed pass 2 over the signal in T (float or bf16_t).
template <bool kBanded, typename T>
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
  // one copy of 4 channels: 16 bytes fp32, 8 bytes bf16
  const bool x_vec16 = cb == kMaxCB && d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const bool z_vec16 = kBanded && d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(z) % (4 * sizeof(T)) == 0;
  const dim3 grid((unsigned)tiles, (unsigned)gx, (unsigned)gy);
#define REPRO_WINDOW_CASE(TN, MT)                                            \
  case TN:                                                                   \
    return window_launch<TN, kBanded, MT, T>(grid, smem, s, x, z, coef, filt, \
                                             y, b, n, d, r, m, left, hf, cb,  \
                                             bw, x_vec16, z_vec16);
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

// The current device and its SM count (read once a device); a CUDA error
// when there is none.
static cudaError_t current_sms(int* dev, int* sms) {
  static int counts[kMaxDevices] = {};
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return e;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[*dev] == 0) {
    e = cudaDeviceGetAttribute(&counts[*dev],
                               cudaDevAttrMultiProcessorCount, *dev);
    if (e != cudaSuccess) return e;
  }
  *sms = counts[*dev];
  return cudaSuccess;
}

// Raise kernel's dynamic shared memory attribute to smem bytes on device
// dev, once (set[dev] remembers what was set; 48 KB needs nothing).
static cudaError_t allow_smem(const void* kernel, long long smem, int dev,
                              long long* set) {
  if (smem <= 48 * 1024 || smem <= set[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) set[dev] = smem;
  return e;
}

// The window of a dense pass-2 tile of tn rows: the most nodes the hat rows
// of one tile touch (node lo of its last row + 1 - node lo of its first, +
// 1), at most r. Exact: the same fp32 hat_row the kernel runs.
static int dense_window(long long n, long long r, long long tn, float hf) {
  long long bw = 2;
  float w;
  for (long long i0 = 0; i0 < n; i0 += tn) {
    const long long i1 = (i0 + tn < n ? i0 + tn : n) - 1;
    const long long span =
        hat_row(i1, hf, (int)r, w) - hat_row(i0, hf, (int)r, w) + 2;
    bw = span > bw ? span : bw;
  }
  return (int)(bw < r ? bw : r);
}

// Dynamic shared memory of a dense pass-2 block, bytes: the x tile of tn
// rows with its halo, the taps, bw window rows of z2, the hat rows and
// nbuf Gram chunks of kt columns.
static long long dense_smem(long long tn, long long m, int kc, int bw, int kt,
                            int nbuf) {
  const long long mp = padded_taps(m);
  return 4 * ((tn + mp - 1) * kLanes + mp * kLanes +
              (bw * kZ2Pitch + 3) / 4 * 4 + 2 * tn +
              (long long)nbuf * dense_chunk_floats(kc, bw, kt));
}

// Dense pass-2 tiles: the largest of 128, 64 and 32 rows that still gives
// the grid a block for each SM (else 32).
static int dense_tile(long long n, long long gx, long long gy, int sms) {
  for (int tn = 128; tn > 32; tn /= 2)
    if ((n + tn - 1) / tn * gx * gy >= sms) return tn;
  return 32;
}

template <int TN, typename T>
static int dense_launch(const dim3& grid, long long smem, cudaStream_t s,
                        int dev, const void* x, const void* z, const void* a,
                        const void* filt, void* y, long long b, long long n,
                        long long d, long long r, long long m, long long left,
                        float hf, int cb, int bw, int kt, int nbuf,
                        bool x_vec16, bool a_vec16, bool a_t) {
  static long long smem_set[kMaxDevices] = {};
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(ski_dense_pass2_kernel<TN, T>), smem,
      dev, smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  ski_dense_pass2_kernel<TN, T><<<grid, kLanes * kWarps, (size_t)smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(z),
      static_cast<const float*>(a), static_cast<const float*>(filt),
      static_cast<T*>(y), b, n, d, (int)r, (int)m, (int)left, hf, cb, bw,
      kt, nbuf, x_vec16, a_vec16, a_t);
  return static_cast<int>(cudaGetLastError());
}

// The dense pass 2 with A, or with A^T read in place (a_t), over the
// signal in T.
template <typename T>
static int dense_pass2(const void* x, const void* z, const void* a,
                       const void* filt, void* y, long long b, long long n,
                       long long d, long long r, long long m, long long left,
                       float hf, bool a_t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  const cudaError_t e = current_sms(&dev, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cb = batch_rows(b);
  const int kc = kLanes / cb;
  const long long gx = (d + kc - 1) / kc, gy = (b + cb - 1) / cb;
  const int tn = dense_tile(n, gx, gy, sms);
  const long long tiles = (n + tn - 1) / tn;
  const int bw = dense_window(n, r, tn, hf);
  // chunks of kt columns of A, nbuf of them in the ring: the widest chunk
  // that leaves room for two blocks a SM (1 KB of a SM is reserved for each
  // block), else the widest that fits one
  int kt = 0, nbuf = 0;
  const long long budgets[2] = {kSmemPerSM / 2 - 1024, kMaxSmem};
  for (int pass = 0; pass < 2 && kt == 0; ++pass) {
    for (int t = 64; t >= 4 && kt == 0; t /= 2) {
      const long long nch = (r + t - 1) / t;
      for (int nb = 3; nb >= 2 && kt == 0; --nb) {
        const int buf = nch < nb ? (int)nch : nb;
        if (dense_smem(tn, m, kc, bw, t, buf) <= budgets[pass]) {
          kt = t;
          nbuf = buf;
        }
      }
    }
  }
  if (kt == 0 || tiles > 2147483647LL || gx > 65535 || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = dense_smem(tn, m, kc, bw, kt, nbuf);
  const bool x_vec16 = cb == kMaxCB && d % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0;
  const bool a_vec16 = !a_t && r % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const dim3 grid((unsigned)tiles, (unsigned)gx, (unsigned)gy);
  switch (tn) {
    case 128:
      return dense_launch<128, T>(grid, smem, s, dev, x, z, a, filt, y,
                                  b, n, d, r, m, left, hf, cb, bw, kt, nbuf,
                                  x_vec16, a_vec16, a_t);
    case 64:
      return dense_launch<64, T>(grid, smem, s, dev, x, z, a, filt, y,
                                 b, n, d, r, m, left, hf, cb, bw, kt, nbuf,
                                 x_vec16, a_vec16, a_t);
    default:
      return dense_launch<32, T>(grid, smem, s, dev, x, z, a, filt, y,
                                 b, n, d, r, m, left, hf, cb, bw, kt, nbuf,
                                 x_vec16, a_vec16, a_t);
  }
}

// One interp_reduce launch over x and z in T (float or bf16_t).
template <typename T>
static int reduce_launch(const T* x, T* z, long long b, long long n,
                         long long d, long long r, double h, float hf,
                         void* stream) {
  const dim3 grid((unsigned)((d + kReduceThreads - 1) / kReduceThreads),
                  (unsigned)r, (unsigned)b);
  interp_reduce_kernel<T><<<grid, kReduceThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, z, n, d, (int)r, h, hf);
  return static_cast<int>(cudaGetLastError());
}

// interp_expand_kernel with lanes of V over z and y.
template <typename V>
static void expand_launch(const dim3& grid, const dim3& block, cudaStream_t s,
                          const void* z, void* y, int n, int cols, int r,
                          float hf, int slabs) {
  interp_expand_kernel<V><<<grid, block, 0, s>>>(
      static_cast<const V*>(z), static_cast<V*>(y), n, cols, r, hf, slabs);
}

// One interp_expand launch over z and y in T (float or bf16_t). A lane
// carries the widest vector of channels that d and both pointers allow:
// fp32 4 (16 bytes) or 1; bf16 8 (16 bytes), 4 (8 bytes) or 1.
template <typename T>
static int expand_pass(const void* z, void* y, long long b, long long n,
                       long long d, long long r, float hf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  const cudaError_t e = current_sms(&dev, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto aligned = [&](int bytes) {
    return reinterpret_cast<uintptr_t>(z) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(y) % bytes == 0;
  };
  int vec = 1;
  for (int v = 16 / (int)sizeof(T); v >= 4 && vec == 1; v /= 2)
    if (d % v == 0 && aligned(v * (int)sizeof(T))) vec = v;
  const long long cols = d / vec;
  // qx lanes along a row: 32, or the row's lanes rounded up to a power of
  // two, at least a span; sy spans a block, halved (down to
  // kExpandMinThreads threads) until every SM has kExpandWave blocks
  int qx = kExpandSpan;
  while (qx < 32 && qx < cols) qx *= 2;
  int sy = kExpandThreads / qx;
  const long long spans = (n + kExpandSpan - 1) / kExpandSpan;
  const long long slabs = (cols + qx - 1) / qx;
  while (qx * sy > kExpandMinThreads &&
         (spans + sy - 1) / sy * slabs * b < (long long)kExpandWave * sms)
    sy /= 2;
  const long long blocks = (spans + sy - 1) / sy * slabs;
  if (blocks > 2147483647LL || b > 65535 || n > 2147483647LL - kExpandSpan ||
      cols > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks, (unsigned)b), block(qx, sy);
  const int ni = (int)n, ci = (int)cols, ri = (int)r, si = (int)slabs;
  if constexpr (kIsF32<T>) {
    if (vec == 4)
      expand_launch<float4>(grid, block, s, z, y, ni, ci, ri, hf, si);
    else
      expand_launch<float>(grid, block, s, z, y, ni, ci, ri, hf, si);
  } else {
    if (vec == 8)
      expand_launch<uint4>(grid, block, s, z, y, ni, ci, ri, hf, si);
    else if (vec == 4)
      expand_launch<uint2>(grid, block, s, z, y, ni, ci, ri, hf, si);
    else
      expand_launch<bf16_t>(grid, block, s, z, y, ni, ci, ri, hf, si);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// The least dynamic shared memory of a dense pass-2 block (tiles of 32
// rows, one chunk of 4 columns of A, 32 channels), bytes: the launch
// refuses a tap count m for which even this exceeds the card's limit.
long long ski_fused_pass2_smem_bytes(long long r, long long m) {
  const long long bw = r < 34 ? r : 34;
  return dense_smem(32, m, kLanes, (int)bw, 4, 1);
}

// x: (b, n, d), z: (b, r, d) contiguous fp32 on the device; 2 <= r <= n,
// h = (n-1)/(r-1) and hf = float32(h). Returns cudaGetLastError(), or
// cudaErrorInvalidValue when the grid exceeds its bounds.
int interp_reduce_f32(const void* x, void* z, long long b, long long n,
                      long long d, long long r, double h, float hf,
                      void* stream) {
  return reduce_launch(static_cast<const float*>(x), static_cast<float*>(z),
                       b, n, d, r, h, hf, stream);
}

// As interp_reduce_f32 over bf16 x and z (fp32 sums, z rounded once).
int interp_reduce_bf16(const void* x, void* z, long long b, long long n,
                       long long d, long long r, double h, float hf,
                       void* stream) {
  return reduce_launch(static_cast<const bf16_t*>(x),
                       static_cast<bf16_t*>(z), b, n, d, r, h, hf, stream);
}

// z: (b, r, d), y: (b, n, d) contiguous fp32 on the device; 2 <= r <= n and
// hf = float32((n-1)/(r-1)). Returns cudaGetLastError(), or
// cudaErrorInvalidValue when the grid exceeds its bounds.
int interp_expand_f32(const void* z, void* y, long long b, long long n,
                      long long d, long long r, float hf, void* stream) {
  return expand_pass<float>(z, y, b, n, d, r, hf, stream);
}

// As interp_expand_f32 over bf16 z and y (fp32 arithmetic, y rounded once).
int interp_expand_bf16(const void* z, void* y, long long b, long long n,
                       long long d, long long r, float hf, void* stream) {
  return expand_pass<bf16_t>(z, y, b, n, d, r, hf, stream);
}

// x, y: (b, n, d); z: (b, r, d); a: (d, r, r); filt: (d, m), contiguous fp32
// on the device; 2 <= r <= n, 0 <= left < m; hf = float32((n-1)/(r-1)).
// Returns cudaGetLastError(), or cudaErrorInvalidValue when the block's
// shared memory would exceed the card's limit or the grid its bounds.
int ski_fused_pass2_f32(const void* x, const void* z, const void* a,
                        const void* filt, void* y, long long b, long long n,
                        long long d, long long r, long long m, long long left,
                        float hf, void* stream) {
  return dense_pass2<float>(x, z, a, filt, y, b, n, d, r, m, left, hf, false,
                            stream);
}

// As ski_fused_pass2_f32 with A^T in place of A, read from A as it lies
// (the signal backward's Gram): no transposed copy of A is made.
int ski_fused_pass2_at_f32(const void* x, const void* z, const void* a,
                           const void* filt, void* y, long long b,
                           long long n, long long d, long long r, long long m,
                           long long left, float hf, void* stream) {
  return dense_pass2<float>(x, z, a, filt, y, b, n, d, r, m, left, hf, true,
                            stream);
}

// As ski_fused_pass2_f32 and ski_fused_pass2_at_f32 with x, z and y bf16 (A
// and filt fp32): the sums in fp32, y rounded once.
int ski_fused_pass2_bf16(const void* x, const void* z, const void* a,
                         const void* filt, void* y, long long b, long long n,
                         long long d, long long r, long long m,
                         long long left, float hf, void* stream) {
  return dense_pass2<bf16_t>(x, z, a, filt, y, b, n, d, r, m, left, hf,
                             false, stream);
}

int ski_fused_pass2_at_bf16(const void* x, const void* z, const void* a,
                            const void* filt, void* y, long long b,
                            long long n, long long d, long long r,
                            long long m, long long left, float hf,
                            void* stream) {
  return dense_pass2<bf16_t>(x, z, a, filt, y, b, n, d, r, m, left, hf, true,
                             stream);
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
      ski_window_pass2_kernel<kTN, true, kMaxMT, float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, ski_window_pass2_kernel<kTN, true, kMaxMT, float>,
      kLanes * kWarps, (size_t)smem);
  return e != cudaSuccess ? -static_cast<int>(e) : nb;
}

// Blocks of ski_fused_pass2 an SM holds at the SKI path's shape (x (8, 512,
// 512), r = 64, m = 32: tiles of 128 rows, one chunk of 64 columns of A)
// on the current device, its shared-memory attribute raised first; or
// minus a CUDA error.
int ski_fused_pass2_blocks_per_sm() {
  const int bw = dense_window(512, 64, 128, 511.f / 63.f);
  const long long smem = dense_smem(128, 32, kLanes / kMaxCB, bw, 64, 1);
  cudaError_t e = cudaFuncSetAttribute(
      ski_dense_pass2_kernel<128, float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int nb = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, ski_dense_pass2_kernel<128, float>, kLanes * kWarps,
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
  return window_pass2<true, float>(x, z, coef, filt, y, b, n, d, r, m, left,
                                   hf, tn, bw, stream);
}

// As ski_windowed_pass2_f32 with z2 = A z (b, r, d) in place of z and no
// coefficients.
int ski_expand_pass2_f32(const void* x, const void* z2, const void* filt,
                         void* y, long long b, long long n, long long d,
                         long long r, long long m, long long left, float hf,
                         long long tn, long long bw, void* stream) {
  return window_pass2<false, float>(x, z2, nullptr, filt, y, b, n, d, r, m,
                                    left, hf, tn, bw, stream);
}

// As ski_windowed_pass2_f32 and ski_expand_pass2_f32 with x, z (z2) and y
// bf16 (the coefficients and filt fp32): the sums in fp32, y rounded once.
int ski_windowed_pass2_bf16(const void* x, const void* z, const void* coef,
                            const void* filt, void* y, long long b,
                            long long n, long long d, long long r,
                            long long m, long long left, float hf,
                            long long tn, long long bw, void* stream) {
  return window_pass2<true, bf16_t>(x, z, coef, filt, y, b, n, d, r, m, left,
                                    hf, tn, bw, stream);
}

int ski_expand_pass2_bf16(const void* x, const void* z2, const void* filt,
                          void* y, long long b, long long n, long long d,
                          long long r, long long m, long long left, float hf,
                          long long tn, long long bw, void* stream) {
  return window_pass2<false, bf16_t>(x, z2, nullptr, filt, y, b, n, d, r, m,
                                     left, hf, tn, bw, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
