"""The launch arithmetic of the dense SKI forward's two CUDA kernels, on the
CPU.

``interp_reduce`` and ``ski_fused_pass2`` (``src/repro_torch/kernels/csrc/
ski.cu``) cut their work by rules that no CPU run of the port reaches: the
wrappers take the plain versions for CPU tensors. This file repeats those
rules in Python, from the constants of the source itself, and checks what
the kernels' correctness rests on, at every ``chip_smoke.SKI_SHAPES`` shape,
at r = 2, r = n, and at the dense route's ceilings r = 181 (d = 512) and
r = 512 (d = 64), on a 132-SM card and on smaller ones:

* ``interp_reduce``: the output of node j gathers the rows within one
  spacing of it (``reduce_rows``), in chunks of ``kReduceThreads``, with
  each row's weight from its hat row. Every (i, j) pair with a non-zero
  weight is summed exactly once, in increasing i.
* ``ski_fused_pass2``: a tile of ``dense_tile`` rows stages the window of
  ``dense_window`` rows of A from the node of its first row, clamped to
  r - bw. Every z₂ row that the tile's hat rows read lies in its window;
  the chunk copies of A (16-byte, 4-byte, and Aᵀ read in place) and of z
  fill every slot of a chunk once, from the right element; the Gram's
  work items cover every (channel, window row) once, and every z₂ element
  sums t = 0 .. r-1 in increasing order across the chunks.

All checks are exact (integers and index sets), except the two float64
reconstructions of z and y from the modelled tilings, which hold to
1e-12 × max (float64 sums in another order).
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from test_torch_ssd_scan import _repo_module  # noqa: E402

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/ski.cu"
#: every ``constexpr int`` of the source, by name
K = {m.group(1): int(m.group(2)) for m in re.finditer(
    r"constexpr int (\w+) = (\d+);", SRC.read_text())}
#: the z2 window's row pitch (``kZ2Pitch = kLanes + 1``)
K["kZ2Pitch"] = K.get("kLanes", 0) + 1

SMOKE = _repo_module("chip_smoke.py")

#: (label, b, n, d, r, m, left): chip_smoke's SKI_SHAPES, its INTERP_R2
#: (r = 2), r = n at the path's length and the two PASS2_CEILING shapes
SHAPES = [*SMOKE.SKI_SHAPES,
          (SMOKE.INTERP_R2[0], *SMOKE.INTERP_R2[1:], 4, 1),
          ("r=n path", 8, 512, 512, 512, 32, 0),
          *((f"ceiling {lab}", b, n, d, r, m, m // 2)
            for lab, b, n, d, r, m in SMOKE.PASS2_CEILING)]
IDS = [s[0] for s in SHAPES]
#: SM counts: the H100's, and small cards that force the other tiles
SMS = (132, 8, 1)


def test_constants_found():
    for name in ("kReduceThreads", "kLanes", "kZ2Pitch", "kWarps", "kMaxCB",
                 "kKB", "kMaxSmem", "kSmemPerSM"):
        assert name in K, name
    assert "constexpr int kZ2Pitch = kLanes + 1;" in SRC.read_text()


# ---------------------------------------------------------------- helpers
def _hat(n, r):
    """(lo, w_lo, h, hf): the kernels' fp32 hat rows (``hat_row``)."""
    lo, w_lo, h = ref.hat_geometry(n, r)
    return lo.astype(np.int64), w_lo, h, np.float32(h)


def _batch_rows(b):
    """``batch_rows``: 8 batch rows a pass-2 block, fewer for a smaller b."""
    cb = 1
    while cb < K["kMaxCB"] and cb < b:
        cb *= 2
    return cb


# ------------------------------------------------------------ interp_reduce
def reduce_rows(j, n, h):
    """The rows the output of node j gathers: |i/h - j| < 1, widened by one
    row on each side for fp32 rounding, inside [0, n)."""
    lo = math.ceil((j - 1) * h) - 1
    hi = math.floor((j + 1) * h) + 1
    return max(lo, 0), min(hi, n - 1)


def reduce_gather(n, r, h, lo, w_lo):
    """The kernel's sums, node by node (every channel and batch row does the
    same): its rows in chunks of ``kReduceThreads``, each row's weight on
    node j from its hat row (w_lo on node lo, 1 - w_lo on lo + 1, else 0).
    Returns {node: [(i, weight), ...]} in the order summed and the rows read
    a node."""
    sums, reads = {}, []
    for j in range(r):
        ia, ib = reduce_rows(j, n, h)
        reads.append(ib - ia + 1)
        terms = []
        for base in range(ia, ib + 1, K["kReduceThreads"]):
            for i in range(base, min(base + K["kReduceThreads"], ib + 1)):
                node = int(lo[i])
                wt = (float(w_lo[i]) if node == j else
                      float(np.float32(1.0) - w_lo[i]) if node + 1 == j
                      else 0.0)
                terms.append((i, wt))
        sums[j] = terms
    return sums, reads


@pytest.mark.parametrize("label,b,n,d,r,m,left", SHAPES, ids=IDS)
def test_interp_reduce_sums_each_pair_once(label, b, n, d, r, m, left):
    lo, w_lo, h, _ = _hat(n, r)
    sums, reads = reduce_gather(n, r, h, lo, w_lo)
    w = ref.hat_interp_matrix(n, r).numpy()
    for j in range(r):
        rows = [i for i, wt in sums[j] if wt != 0.0]
        assert rows == sorted(rows)                # increasing i
        want = [i for i in range(n) if w[i, j] != 0.0]
        assert rows == want, j                     # every pair, once
        for i, wt in sums[j]:
            if wt != 0.0:
                assert np.float32(wt) == np.float32(w[i, j])
    # each row is read by the nodes within one spacing of it: at most
    # 2 h + 3 rows a node
    assert max(reads) <= 2 * h + 3


@pytest.mark.parametrize("label,b,n,d,r,m,left", SHAPES, ids=IDS)
def test_interp_reduce_gather_gives_the_plain_version(label, b, n, d, r, m,
                                                      left):
    """z rebuilt in float64 from the modelled gathers equals Wᵀx."""
    lo, w_lo, h, _ = _hat(n, r)
    sums, _ = reduce_gather(n, r, h, lo, w_lo)
    x = np.random.default_rng(0).standard_normal((2, n, 3))
    got = np.zeros((2, r, 3))
    for j, terms in sums.items():
        for i, wt in terms:
            got[:, j] += wt * x[:, i]
    want = np.einsum("nr,bnd->brd", ref.hat_interp_matrix(n, r).double()
                     .numpy(), x)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# ---------------------------------------------------------- ski_fused_pass2
def dense_tile(n, gx, gy, sms):
    """``dense_tile``: the largest of 128, 64, 32 rows that gives each SM a
    block, else 32."""
    for tn in (128, 64):
        if -(-n // tn) * gx * gy >= sms:
            return tn
    return 32


def dense_window(n, r, tn, lo):
    """``dense_window``: the most nodes one tile's hat rows touch."""
    bw = 2
    for i0 in range(0, n, tn):
        i1 = min(i0 + tn, n) - 1
        bw = max(bw, int(lo[i1] - lo[i0]) + 2)
    return min(bw, r)


def padded_taps(m):
    return -(-m // K["kKB"]) * K["kKB"]


def chunk_floats(kc, bw, kt):
    """``dense_chunk_floats``: z's kt rows of the block's channels (batch
    rows padded to 8) and A's window."""
    return kc * kt * K["kMaxCB"] + kc * bw * (kt + 4)


def dense_smem(tn, m, kc, bw, kt, nbuf):
    """``dense_smem``: the x tile and halo, the taps, the z₂ window, the
    hat rows and the chunk ring."""
    mp = padded_taps(m)
    return 4 * ((tn + mp - 1) * K["kLanes"] + mp * K["kLanes"]
                + (bw * K["kZ2Pitch"] + 3) // 4 * 4 + 2 * tn
                + nbuf * chunk_floats(kc, bw, kt))


def dense_chunks(r, tn, m, kc, bw):
    """(kt, nbuf) of ``dense_pass2``: the widest chunk that leaves room for
    two blocks a SM, else the widest that fits one."""
    for budget in (K["kSmemPerSM"] // 2 - 1024, K["kMaxSmem"]):
        for kt in (64, 32, 16, 8, 4):
            nch = -(-r // kt)
            for nb in (3, 2):
                buf = min(nch, nb)
                if dense_smem(tn, m, kc, bw, kt, buf) <= budget:
                    return kt, buf
    return None


def dense_launch(b, n, d, r, m, sms):
    """(cb, kc, gx, gy, tn, bw, (kt, nbuf)) of ``dense_pass2``: a block
    cb batch rows x kc = 32 / cb channels."""
    cb = _batch_rows(b)
    kc = K["kLanes"] // cb
    gx, gy = -(-d // kc), -(-b // cb)
    lo, _, _, _ = _hat(n, r)
    tn = dense_tile(n, gx, gy, sms)
    bw = dense_window(n, r, tn, lo)
    return cb, kc, gx, gy, tn, bw, dense_chunks(r, tn, m, kc, bw)


def tile_window(i0, r, bw, lo):
    """The kernel's w0: the node of the tile's first row, clamped to
    r - bw."""
    return min(int(lo[i0]), max(r - bw, 0))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label,b,n,d,r,m,left", SHAPES, ids=IDS)
def test_pass2_windows_cover_the_tiles(label, b, n, d, r, m, left, sms):
    lo, _, _, _ = _hat(n, r)
    cb, kc, gx, gy, tn, bw, chunks = dense_launch(b, n, d, r, m, sms)
    assert chunks is not None
    kt, nbuf = chunks
    assert dense_smem(tn, m, kc, bw, kt, nbuf) <= K["kMaxSmem"]
    assert cb * kc == K["kLanes"] and gx < 65536 and gy < 65536
    assert bw <= min(r, tn + 2) and bw <= 8 * (-(-bw // 8))
    staged = 0
    for i0 in range(0, n, tn):
        w0 = tile_window(i0, r, bw, lo)
        assert 0 <= w0 and w0 + bw <= r            # A rows staged exist
        rows = np.arange(i0, min(i0 + tn, n))
        # the expansion reads window rows lo - w0 and lo + 1 - w0
        assert (lo[rows] - w0).min() >= 0
        assert (lo[rows] + 1 - w0).max() < bw
        staged += bw
    if label == "path" and sms == 132:
        # about once: 4 tiles of 128 rows stage 72 of A's 64 rows
        assert (tn, bw, kt, nbuf) == (128, 18, 64, 1)
        assert staged <= 1.15 * r


def _copy_slots(kind, bw, kc, kt, r, d, w0, t0, c0):
    """The A-chunk copies of ``load_dense_chunk`` as (slot, source index
    into A's flat (d, r, r), or -1 for a zero fill) for every copy that a
    thread of the block issues; A's window lies as [ch][s][t]."""
    ktp, rr, out = kt + 4, r * r, []
    if kind == "vec16":
        kt4 = kt // 4
        for e in range(bw * kc * kt4):
            row, t = e // kt4, 4 * (e % kt4)
            ch, s = row // bw, row % bw
            ok = c0 + ch < d and w0 + s < r and t0 + t < r
            src = (c0 + ch) * rr + (w0 + s) * r + t0 + t
            out += [(row * ktp + t + q, src + q if ok else -1)
                    for q in range(4)]
    elif kind == "scalar":
        for e in range(bw * kc * kt):
            row, t = e // kt, e % kt
            ch, s = row // bw, row % bw
            ok = c0 + ch < d and w0 + s < r and t0 + t < r
            out.append((row * ktp + t, (c0 + ch) * rr + (w0 + s) * r + t0 + t
                        if ok else -1))
    else:                            # A^T in place: a warp a (ch, t)
        for q in range(kc * kt):
            ch, t = q // kt, q % kt
            for s in range(bw):              # the warp's lanes, along s
                ok = c0 + ch < d and w0 + s < r and t0 + t < r
                out.append(((ch * bw + s) * ktp + t, (c0 + ch) * rr
                            + (t0 + t) * r + w0 + s if ok else -1))
    return out


#: (kind, shape): the 16-byte copies only where A's rows are 16-byte
#: aligned (r % 4 == 0), as ``dense_pass2`` takes them
COPIES = [(kind, s) for s in SHAPES for kind in ("vec16", "scalar",
                                                 "transposed")
          if kind != "vec16" or s[4] % 4 == 0]


@pytest.mark.parametrize("kind,shape", COPIES,
                         ids=[f"{k}-{s[0]}" for k, s in COPIES])
def test_pass2_chunk_copies_fill_each_slot_once(kind, shape):
    label, b, n, d, r, m, left = shape
    lo, _, _, _ = _hat(n, r)
    cb, kc, gx, gy, tn, bw, (kt, nbuf) = dense_launch(b, n, d, r, m, 132)
    a = np.arange(d * r * r)
    # the last column group and the last chunk hold the padding
    c0 = (gx - 1) * kc
    w0 = tile_window(((n - 1) // tn) * tn, r, bw, lo)
    for t0 in sorted({0, ((r - 1) // kt) * kt}):
        slots = _copy_slots(kind, bw, kc, kt, r, d, w0, t0, c0)
        got = {}
        for slot, src in slots:
            assert slot not in got                  # written once
            got[slot] = src
        ktp = kt + 4
        want = {(ch * bw + s) * ktp + t for s in range(bw)
                for ch in range(kc) for t in range(kt)}
        assert set(got) == want                     # every slot
        for s in range(bw):
            for ch in range(kc):
                for t in range(kt):
                    src = got[(ch * bw + s) * ktp + t]
                    inside = c0 + ch < d and w0 + s < r and t0 + t < r
                    if not inside:
                        assert src == -1            # zero fill
                        continue
                    c, row, col = c0 + ch, w0 + s, t0 + t
                    if kind == "transposed":
                        row, col = col, row         # A^T[c, s, t] = A[c, t, s]
                    assert a[src] == (c * r + row) * r + col


def _z_slots(kc, cb, kt, t0, r, d, b, b0, c0):
    """The z-chunk copies of ``load_dense_chunk``: (slot, (batch row, t,
    channel) or None for a zero fill), z's chunk lying as [ch][t][u]."""
    out = []
    for e in range(kt * K["kMaxCB"] * kc):
        ch, q = e % kc, e // kc
        t, u = q // 8, q % 8
        ok = u < cb and b0 + u < b and c0 + ch < d and t0 + t < r
        out.append(((ch * kt + t) * K["kMaxCB"] + u,
                    (b0 + u, t0 + t, c0 + ch) if ok else None))
    return out


@pytest.mark.parametrize("label,b,n,d,r,m,left", SHAPES, ids=IDS)
def test_pass2_z_copies_fill_each_slot_once(label, b, n, d, r, m, left):
    cb, kc, gx, gy, tn, bw, (kt, _) = dense_launch(b, n, d, r, m, 132)
    b0, c0 = (gy - 1) * cb, (gx - 1) * kc       # the ragged corner
    for t0 in sorted({0, ((r - 1) // kt) * kt}):
        copies = _z_slots(kc, cb, kt, t0, r, d, b, b0, c0)
        slots = dict(copies)
        assert len(slots) == len(copies) == kc * kt * K["kMaxCB"]
        for slot, src in slots.items():             # slot = (ch kt + t) 8 + u
            ch, t, u = slot // (kt * 8), slot // 8 % kt, slot % 8
            inside = (u < cb and b0 + u < b and c0 + ch < d and t0 + t < r)
            assert src == ((b0 + u, t0 + t, c0 + ch) if inside else None)


@pytest.mark.parametrize("label,b,n,d,r,m,left", SHAPES, ids=IDS)
def test_pass2_gram_rows_and_order(label, b, n, d, r, m, left):
    """``dense_gram_chunk``'s work items: item q = (ch, s) takes window
    rows s and s + ceil(bw / 2) of channel ch for the batch rows; each
    (channel, row) pair belongs to one item, and each z₂ element sums its
    chunks' t in increasing order, every t < r once (the padding past r
    multiplies zeros)."""
    _, kc, _, _, tn, bw, (kt, _) = dense_launch(b, n, d, r, m, 132)
    half = (bw + 1) // 2
    owner = {}
    for q in range(kc * half):
        ch, s0 = q // half, q % half
        for s in (s0, s0 + half):
            if s < bw:
                assert (ch, s) not in owner
                owner[(ch, s)] = q
    assert sorted(owner) == [(ch, s) for ch in range(kc) for s in range(bw)]
    order = [t for ch in range(-(-r // kt)) for t0 in range(0, kt, 4)
             for t in range(ch * kt + t0, ch * kt + t0 + 4)]
    assert order == sorted(order)
    assert [t for t in order if t < r] == list(range(r))


@pytest.mark.parametrize("label,b,n,d,r,m,left", SHAPES, ids=IDS)
def test_pass2_tiling_gives_the_plain_version(label, b, n, d, r, m, left):
    """y rebuilt in float64 from the modelled tiles (each tile's z₂ window
    from its staged rows of A alone, then the expansion from the window
    and the conv) equals the float64 plain pass 2, with A and with Aᵀ."""
    lo, w_lo, _, _ = _hat(n, r)
    _, _, _, _, tn, bw, _ = dense_launch(b, n, d, r, m, 132)
    dd = min(d, 3)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, n, dd)))
    z = torch.from_numpy(rng.standard_normal((2, r, dd)))
    a = torch.from_numpy(rng.standard_normal((dd, r, r)))
    f = torch.from_numpy(rng.standard_normal((dd, m)))
    conv = ref._shift_conv(x, f, left).double()
    for transpose in (False, True):
        at = a.transpose(1, 2) if transpose else a
        y = torch.empty(2, n, dd, dtype=torch.float64)
        for i0 in range(0, n, tn):
            w0 = tile_window(i0, r, bw, lo)
            z2w = torch.einsum("dst,btd->bsd", at[:, w0:w0 + bw], z)
            for i in range(i0, min(i0 + tn, n)):
                j = lo[i] - w0
                y[:, i] = (float(w_lo[i]) * z2w[:, j]
                           + (1.0 - float(w_lo[i])) * z2w[:, j + 1])
        y += conv
        z2 = torch.einsum("dst,btd->bsd", at, z)
        w = ref.hat_interp_matrix(n, r).double()
        want = torch.einsum("nr,brd->bnd", w, z2) + conv
        assert float((y - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
