"""The launch arithmetic of the SKI backward's two parameter-cotangent CUDA
kernels, on the CPU.

``conv_tap_grad`` and ``gram_grad`` (``src/repro_torch/kernels/csrc/
ski_grad.cu``) cut their work by rules that no CPU run of the port reaches:
the wrappers take the plain versions for CPU tensors. This file repeats
those rules in Python, from the constants of the source itself, and checks
what the kernels' correctness rests on, at every ``chip_smoke.SKI_SHAPES``
shape, at n < m, m = 1, m = 400, small batches and ragged d, and for
``gram_grad`` at r in {1, 2, 11, 64, 181, 512} on 132-, 8- and 1-SM cards:

* ``conv_tap_grad``: ``kTapSplit`` blocks split a tile's batch rows into
  pieces (``conv_tap_grad_pieces``) and stream each piece in chunks of
  ``kChunk`` rows through a ring of g slots and a ring of ``kXRing`` x
  rows, ``kStages`` chunks in flight. Replaying the copies and the
  register-window reads in program order, every (b, j, k) pair whose x row
  lies in [0, n) is summed exactly once, from the right g and x rows, and
  no copy in flight overwrites a row that a chunk still reads; the warps'
  sums and then the blocks' (by the block that draws the tile's last
  ticket) are added in one fixed order, and a numpy float32 emulation of
  that order matches ``ref.conv_tap_grad_ref`` within 1e-5 × max.
* ``gram_grad``: the items (4 channels x 64 rows s x 64 columns t) that a
  grid of at most ``kGBlocksPerSM`` blocks an SM walks write every (c, s,
  t) of dA exactly once; each step copies each (batch row, row) of its
  tiles once; z's swizzled rows are a bijection and conflict-free for the
  16-byte reads of a quarter warp; the fmaf chain over b (8 batch rows a
  step, rows past b zero) matches ``ref.gram_grad_ref`` within 1e-6 × max.
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

SRC = (Path(__file__).resolve().parents[1]
       / "src/repro_torch/kernels/csrc/ski_grad.cu")
TEXT = SRC.read_text()
#: every ``constexpr int`` of the source set to a number, by name
K = {m.group(1): int(m.group(2)) for m in re.finditer(
    r"constexpr int (\w+) = (\d+);", TEXT)}
#: the derived constants, as the source defines them
DERIVED = {"kWarps": "kThreads / 32", "kTQ": "kTC / 4", "kTG": "kTT / kTK",
           "kWRows": "kChunk / kWarps", "kHalo": "kTT - 1",
           "kMaxTickets": "1 << 16"}
for _name, _expr in DERIVED.items():
    # C++ integer arithmetic of the source's own text
    K[_name] = eval(_expr.replace("/", "//"), {}, dict(K))  # noqa: S307

SMOKE = _repo_module("chip_smoke.py")

#: (label, b, n, d, m, left) for conv_tap_grad: chip_smoke's SKI_SHAPES
#: and TAP_GRAD_SHAPES (m = 400, 13 tap passes, cut to a few channels;
#: b = 12, two batch rows a block), small batches (a batch row cut into
#: pieces), n < m with 4-byte copies, one row
TAP_SHAPES = [
    *((label, b, n, d, m, left)
      for label, b, n, d, r, m, left in SMOKE.SKI_SHAPES),
    ("m=400", 2, 450, 12, *SMOKE.TAP_GRAD_SHAPES[0][4:]),
    SMOKE.TAP_GRAD_SHAPES[1],
    ("b=1", 1, 512, 64, 32, 0), ("b=3 ragged", 3, 301, 37, 9, 4),
    ("n<m b=1", 1, 5, 7, 33, 32), ("n=1", 4, 1, 8, 3, 1),
    ("b=9", 9, 140, 36, 32, 16)]
TAP_IDS = [s[0] for s in TAP_SHAPES]
#: (b, r, d) for gram_grad: the SKI path, both dense ceilings, ragged d
GRAM_SHAPES = [(8, r, d) for r in (1, 2, 11, 64) for d in (45, 512)]
GRAM_SHAPES += [(8, 181, 512), (8, 512, 64), (3, 181, 5), (9, 64, 33),
                (17, 11, 8)]
GRAM_IDS = [f"b={b},r={r},d={d}" for b, r, d in GRAM_SHAPES]
SMS = (132, 8, 1)


def test_constants_found():
    for name in ("kThreads", "kTapSplit", "kTC", "kTT", "kTK", "kChunk",
                 "kHalf", "kStages", "kXRing", "kMinPiece", "kGC", "kGS",
                 "kGT", "kGB", "kGSR", "kGStages", "kGBlocksPerSM",
                 "kGThreads"):
        assert name in K, name
    for name, expr in DERIVED.items():
        assert f"constexpr int {name} = {expr};" in TEXT, name
    # the ring is a power of two (its rows are masked, not divided)
    assert K["kXRing"] & (K["kXRing"] - 1) == 0
    assert K["kTQ"] * K["kTG"] == 32 and K["kWRows"] % K["kHalf"] == 0


# ------------------------------------------------------------ conv_tap_grad
def _pieces(b, n):
    """``conv_tap_grad_pieces``: pieces a batch row is cut into."""
    want = -(-K["kTapSplit"] // b)
    most = -(-n // K["kMinPiece"])
    return max(1, min(want, most))


def _chunks(b, n, rank):
    """The block's chunks in program order, as its cursor walks them
    (``tap_piece`` / ``tap_next``): (seq, batch row, j0, rows, chunk,
    xpos)."""
    spr = _pieces(b, n)
    length = -(-n // spr)
    out, seq, xpos = [], 0, 0
    for piece in range(rank, b * spr, K["kTapSplit"]):
        bi, q = divmod(piece, spr)
        j0 = q * length
        rows = min(length, n - j0)
        if rows <= 0:
            continue
        nch = -(-rows // K["kChunk"])
        for c in range(nch):
            out.append((seq, bi, j0, rows, c, xpos))
            seq += 1
        xpos += nch * K["kChunk"] + K["kHalo"]
    return out


def _loads(ch, n, k0, left):
    """``tap_load``: {g slot row: (bi, j) or None}, {x ring row: (bi, i) or
    None} of one chunk (None: zero-filled)."""
    seq, bi, j0, rows, c, xpos = ch
    r0 = c * K["kChunk"]
    g = {}
    for row in range(K["kChunk"]):
        slot = (seq % K["kStages"]) * K["kChunk"] + row
        g[slot] = (bi, j0 + r0 + row) if r0 + row < rows else None
    lo = 0 if c == 0 else r0 + K["kHalo"]
    hi = r0 + K["kChunk"] + K["kHalo"]
    xi0 = j0 - k0 - K["kHalo"] + left
    x = {}
    for w in range(lo, hi):
        i = xi0 + w
        x[(xpos + w) & (K["kXRing"] - 1)] = (bi, i) if 0 <= i < n else None
    return g, x


def _reads(ch):
    """The compute of one chunk: for each warp, half window h, row q and
    lane tap kt = kTK tg + kk, the g slot row and x ring row it reads (the
    kernel's own index expressions). Yields (warp, h, q, kt, g, x)."""
    seq, bi, j0, rows, c, xpos = ch
    tk = K["kTK"]
    for warp in range(K["kWarps"]):
        for tg in range(K["kTG"]):
            wb0 = (xpos + c * K["kChunk"] + warp * K["kWRows"] + K["kHalo"]
                   - (tk - 1) - tk * tg)
            for h in range(0, K["kWRows"], K["kHalf"]):
                for q in range(K["kHalf"]):
                    grow = ((seq % K["kStages"]) * K["kChunk"]
                            + warp * K["kWRows"] + h + q)
                    for kk in range(tk):
                        e = q + tk - 1 - kk
                        yield (warp, h, q, tk * tg + kk, grow,
                               (wb0 + h + e) & (K["kXRing"] - 1))


def _replay(b, n, m, left):
    """Every block of every tap pass in program order: the prologue's
    kStages - 1 chunk copies, then for chunk G the copy of chunk G +
    kStages - 1 (issued before G's compute, so it may land first) and G's
    reads. Returns {(bi, j, k): times summed} and asserts each read finds
    the row it needs."""
    summed = {}
    stages = K["kStages"]
    for k0 in range(0, m, K["kTT"]):
        for rank in range(K["kTapSplit"]):
            chunks = _chunks(b, n, rank)
            gring, xring = {}, {}
            for ch in chunks[:stages - 1]:
                g, x = _loads(ch, n, k0, left)
                gring.update(g)
                xring.update(x)
            for gi, ch in enumerate(chunks):
                if gi + stages - 1 < len(chunks):
                    g, x = _loads(chunks[gi + stages - 1], n, k0, left)
                    gring.update(g)
                    xring.update(x)
                seq, bi, j0, rows, c, xpos = ch
                for warp, h, q, kt, grow, xrow in _reads(ch):
                    jj = c * K["kChunk"] + warp * K["kWRows"] + h + q
                    k = k0 + kt
                    want_g = (bi, j0 + jj) if jj < rows else None
                    assert gring[grow] == want_g, (ch, warp, h, q)
                    i = j0 + jj - k + left
                    want_x = (bi, i) if 0 <= i < n else None
                    assert xring[xrow] == want_x, (ch, warp, h, q, kt)
                    if want_g is not None and want_x is not None and k < m:
                        key = (bi, j0 + jj, k)
                        summed[key] = summed.get(key, 0) + 1
    return summed


@pytest.mark.parametrize("label,b,n,d,m,left", TAP_SHAPES, ids=TAP_IDS)
def test_tap_grad_pieces_cover_each_row_once(label, b, n, d, m, left):
    """The tile's blocks take every row of every batch row once, a batch
    row in at most ceil(n / kMinPiece) pieces, a block at most one piece
    more than another."""
    cover = np.zeros((b, n), dtype=np.int64)
    per_rank = []
    assert _pieces(b, n) <= max(1, -(-n // K["kMinPiece"]))
    for rank in range(K["kTapSplit"]):
        pieces = set()
        for seq, bi, j0, rows, c, xpos in _chunks(b, n, rank):
            r0 = c * K["kChunk"]
            cover[bi, j0 + r0:j0 + min(rows, r0 + K["kChunk"])] += 1
            pieces.add((bi, j0))
        per_rank.append(len(pieces))
    assert (cover == 1).all()
    assert max(per_rank) - min(per_rank) <= 1


@pytest.mark.parametrize("label,b,n,d,m,left",
                         [s for s in TAP_SHAPES if s[0] != "m=400"],
                         ids=[i for i in TAP_IDS if i != "m=400"])
def test_tap_grad_sums_each_pair_once(label, b, n, d, m, left):
    """Replaying the ring copies and the window reads: every read finds its
    g and x row (or a zero), and every (b, j, k) pair with x in range is
    summed exactly once."""
    summed = _replay(b, n, m, left)
    want = {(bi, j, k) for bi in range(b) for j in range(n) for k in range(m)
            if 0 <= j - k + left < n}
    assert set(summed) == want
    assert set(summed.values()) <= {1}
    pairs = sum(max(0, min(n, n + k - left) - max(0, k - left))
                for k in range(m))
    assert len(summed) == b * pairs == b * SMOKE._tap_pairs(n, m, left)


def test_tap_grad_ring_holds_the_chunks_in_flight():
    """The static bound behind the replay: kStages windows of kChunk +
    kHalo rows fit in the x ring, and the warps' sums fit in it."""
    assert K["kXRing"] >= K["kStages"] * (K["kChunk"] + K["kHalo"])
    assert K["kWarps"] * K["kTT"] * K["kTC"] <= K["kXRing"] * K["kTC"]
    # the g slot a chunk's copy fills is never the one being read
    for g in range(8):
        assert (g + K["kStages"] - 1) % K["kStages"] != g % K["kStages"]


def _fma(a, b, c):
    """fmaf in float32: the product is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _tap_grad_emulated(g, x, m, left):
    """df in the kernel's order: each lane's chain over its block's chunks,
    window halves and rows; the warps' sums added in warp order from 0; the
    blocks' sums in block order from 0. float32 throughout."""
    b, n, d = x.shape
    tt, kc, ws = K["kTT"], K["kChunk"], K["kWRows"]
    passes = -(-m // tt)
    xp = np.zeros((b, n + 2 * (m + kc + tt), d), dtype=np.float32)
    off = m + kc + tt                        # x row i at xp[:, off + i]
    xp[:, off:off + n] = x
    df = np.zeros((d, passes * tt), dtype=np.float32)
    for p in range(passes):
        k = p * tt + np.arange(tt)
        total = np.zeros((tt, d), dtype=np.float32)
        for rank in range(K["kTapSplit"]):
            acc = np.zeros((K["kWarps"], tt, d), dtype=np.float32)
            for seq, bi, j0, rows, c, xpos in _chunks(b, n, rank):
                for step in range(ws):             # h + q, in order
                    jj = c * kc + np.arange(K["kWarps"]) * ws + step
                    ok = (jj < rows)[:, None, None]
                    j = j0 + np.minimum(jj, rows - 1)
                    gv = np.where(ok, g[bi, j][:, None, :], 0)
                    xi = off + j[:, None] - k[None, :] + left
                    acc = _fma(gv, xp[bi, xi], acc)
            part = np.zeros((tt, d), dtype=np.float32)
            for w in range(K["kWarps"]):
                part = part + acc[w]
            total = total + part
        df[:, p * tt:(p + 1) * tt] = total.T
    return df[:, :m]


@pytest.mark.parametrize("label,b,n,d,m,left", TAP_SHAPES, ids=TAP_IDS)
def test_tap_grad_order_gives_the_plain_version(label, b, n, d, m, left):
    """The emulated order within 1e-5 × max of ref.conv_tap_grad_ref (the
    card's tolerance: sums of up to b n terms in another order)."""
    rng = np.random.default_rng(23)
    d = min(d, 24)                           # the order is per channel
    g = rng.standard_normal((b, n, d), dtype=np.float32)
    x = rng.standard_normal((b, n, d), dtype=np.float32)
    got = _tap_grad_emulated(g, x, m, left)
    want = ref.conv_tap_grad_ref(torch.from_numpy(g), torch.from_numpy(x), m,
                                 left).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tap_grad_workspace_and_tickets():
    """Each block writes its kTT x kTC sums to its own slot of the
    workspace (``conv_tap_grad_workspace_floats``: kTapSplit slots a tile
    and tap pass), one ticket a (tile, pass) up to kMaxTickets, and the
    last block's padded [tap][kTC + 1] tile fits in the g ring and stores
    df channel-major, each output once."""
    tt, tc, split = K["kTT"], K["kTC"], K["kTapSplit"]
    for d, m in ((512, 32), (45, 4), (5, 400), (33, 1)):
        tiles, passes = -(-d // tc), -(-m // tt)
        slots = {(t, rank) for t in range(tiles * passes)
                 for rank in range(split)}
        assert len(slots) * tt * tc == tiles * passes * split * tt * tc
    assert tt * (tc + 1) <= K["kStages"] * K["kChunk"] * tc
    o = np.arange(tt * tc)
    seen = np.zeros((tc, tt), dtype=np.int64)
    np.add.at(seen, (o // tt, o % tt), 1)
    assert (seen == 1).all()


# ---------------------------------------------------------------- gram_grad
def _swz(t):
    """``swz``: z's tile row t at row t ^ ((t >> 3) & 3)."""
    return t ^ ((t >> 3) & 3)


def _col(tq, j, vec):
    """``gram_col``: 4 consecutive columns a thread for 16-byte stores (r %
    4 == 0), else columns tq + 16 j."""
    return 4 * tq + j if vec else tq + (K["kGT"] // 4) * j


def _gram_items(r, d):
    nst, ntt = -(-r // K["kGS"]), -(-r // K["kGT"])
    return -(-d // K["kGC"]) * nst * ntt, nst, ntt


def _gram_grid(r, d, sms):
    items, _, _ = _gram_items(r, d)
    return min(items, sms * K["kGBlocksPerSM"])


def _item(item, nst, ntt):
    """(cg, st, tt) of an item, as ``gram_step`` splits it."""
    cg, rem = divmod(item, nst * ntt)
    st, tt = divmod(rem, ntt)
    return cg, st, tt


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,r,d", GRAM_SHAPES, ids=GRAM_IDS)
def test_gram_items_write_each_element_once(b, r, d, sms):
    items, nst, ntt = _gram_items(r, d)
    grid = _gram_grid(r, d, sms)
    written = np.zeros((d, r, r), dtype=np.int64)
    tq = np.arange(K["kGThreads"]) % (K["kGT"] // 4)
    sq = np.arange(K["kGThreads"]) // (K["kGT"] // 4)
    walked = []
    for blk in range(grid):
        mine = (items - 1 - blk) // grid + 1
        for i in range(mine):
            item = blk + i * grid
            walked.append(item)
            cg, st, tt = _item(item, nst, ntt)
            for c in range(K["kGC"]):
                ch = cg * K["kGC"] + c
                for i in range(K["kGSR"]):
                    s = st * K["kGS"] + K["kGSR"] * sq + i
                    for j in range(4):
                        t = tt * K["kGT"] + _col(tq, j, r % 4 == 0)
                        ok = (ch < d) & (s < r) & (t < r)
                        np.add.at(written, (np.full(ok.sum(), ch), s[ok],
                                            t[ok]), 1)
    assert sorted(walked) == list(range(items))
    assert (written == 1).all()


@pytest.mark.parametrize("b,r,d", GRAM_SHAPES, ids=GRAM_IDS)
def test_gram_step_copies_each_row_once(b, r, d):
    """A step's copies (kGB kGS / kGThreads gz rows and kGB kGT / kGThreads
    z rows a thread) fill every (batch row, row) slot of the gz and z
    tiles once."""
    threads = K["kGThreads"]
    e = (np.arange(threads)[:, None]
         + threads * np.arange(K["kGB"] * K["kGS"] // threads))
    slots = (e // K["kGS"]) * K["kGS"] + e % K["kGS"]
    assert sorted(slots.ravel()) == list(range(K["kGB"] * K["kGS"]))
    e = (np.arange(threads)[:, None]
         + threads * np.arange(K["kGB"] * K["kGT"] // threads))
    bb, row = e // K["kGT"], e % K["kGT"]
    zslots = bb * K["kGT"] + _swz(row)
    assert sorted(zslots.ravel()) == list(range(K["kGB"] * K["kGT"]))
    assert (K["kGS"] // K["kGSR"]) * (K["kGT"] // 4) == K["kGThreads"]
    nb = -(-b // K["kGB"])
    assert nb * K["kGB"] >= b


def test_gram_swizzle_is_conflict_free():
    """z's rows of the 8 lanes of a quarter warp (tq = 0..7 or 8..15), 4 tq
    + j or tq + 16 j, fall in 8 distinct 16-byte bank groups, for each j;
    the swizzle permutes rows within each group of 8."""
    for t0 in range(0, K["kGT"], 8):
        assert sorted(_swz(t) for t in range(t0, t0 + 8)) == list(
            range(t0, t0 + 8))
    for quarter in (range(0, 8), range(8, 16)):
        for j in range(4):
            for vec in (True, False):
                groups = {_swz(_col(tq, j, vec)) % 8 for tq in quarter}
                assert len(groups) == 8
    # the 4-byte stores of a half warp cover 64 consecutive bytes
    for j in range(4):
        cols = sorted(_col(tq, j, False) for tq in range(16))
        assert cols == list(range(cols[0], cols[0] + 16))


def _gram_emulated(gz, z):
    """dA in the kernel's order: fmaf over b = 0 .. 8 nb - 1 from 0, the
    rows past b zero."""
    b, r, d = z.shape
    nb = -(-b // K["kGB"])
    acc = np.zeros((d, r, r), dtype=np.float32)
    for bi in range(nb * K["kGB"]):
        if bi < b:
            g1 = gz[bi].T[:, :, None]
            z1 = z[bi].T[:, None, :]
        else:
            g1 = np.zeros((d, r, 1), np.float32)
            z1 = np.zeros((d, 1, r), np.float32)
        acc = _fma(g1, z1, acc)
    return acc


@pytest.mark.parametrize("b,r,d", [s for s in GRAM_SHAPES if s[1] <= 181],
                         ids=[i for i, s in zip(GRAM_IDS, GRAM_SHAPES)
                              if s[1] <= 181])
def test_gram_order_gives_the_plain_version(b, r, d):
    rng = np.random.default_rng(11)
    d = min(d, 16)
    gz = rng.standard_normal((b, r, d), dtype=np.float32)
    z = rng.standard_normal((b, r, d), dtype=np.float32)
    got = _gram_emulated(gz, z)
    want = ref.gram_grad_ref(torch.from_numpy(gz), torch.from_numpy(z))
    want = want.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_gram_chain_is_the_parent_chain():
    """The earlier kernel also ran fmaf over b from 0 in steps of 8 with
    rows past b zero (its kGB = 8): the kernels' bit-for-bit claim rests on
    the same step and the same argument order, fmaf(gz, z, acc)."""
    assert K["kGB"] == 8
    body = TEXT[TEXT.index("gram_grad_kernel(const"):]
    assert "fmaf(gv[i].x, zv[j].x, acc[0][i][j])" in body
    assert math.gcd(K["kGS"], 4) == 4 and math.gcd(K["kGT"], 4) == 4
