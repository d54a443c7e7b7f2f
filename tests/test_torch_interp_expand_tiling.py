"""The launch arithmetic of the ``interp_expand`` CUDA kernel, on the CPU.

``interp_expand`` (``src/repro_torch/kernels/csrc/ski.cu``) cuts y = W z
by rules that no CPU run of the port reaches: the wrapper takes the plain
version for CPU tensors. This file repeats those rules in Python, from the
constants of the source itself, at every ``chip_smoke.SKI_SHAPES`` shape,
``INTERP_R2``, r = n and r = 8 at the path's length, the Appendix B sizes
(4, 2048, 64) and (4, 8192, 64) at r = 64, and the path on the scalar
route (z and y not 16-byte aligned), on a 132-SM card and on smaller ones:

* the launch (``interp_expand_f32``): qx lanes of V (float4 or float)
  along a row, sy spans of ``kExpandSpan`` rows a block, sy halved until
  every SM has ``kExpandWave`` blocks; the grid's bounds;
* a thread's span rows reach it by warp shuffles from the lanes of its
  own span (the group of qx lanes it lies in), each lane having divided
  for one row;
* every (b, i, c) of y is written exactly once;
* each stored row's two nodes lie in what the thread holds: the span's
  window of at most ``kExpandWindow`` node rows, each read once, or on the
  other route the row's own pair; every node read exists;
* y rebuilt in float64 from the modelled reads and weights equals the
  float64 contraction with the reference's W (``ref.hat_interp_matrix``,
  the matrix ``ref.interp_expand_ref`` contracts) to 1e-12 × max.
"""
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

SMOKE = _repo_module("chip_smoke.py")

#: (label, b, n, d, r, vec): vec False forces the scalar route (z or y
#: not 16-byte aligned) where d % 4 == 0
SHAPES = [*((label, b, n, d, r, d % 4 == 0)
            for label, b, n, d, r, _, _ in SMOKE.SKI_SHAPES),
          (*SMOKE.INTERP_R2, SMOKE.INTERP_R2[3] % 4 == 0),
          *((f"run {label}", b, n, d, r, True)
            for label, b, n, d, r in SMOKE.EXPAND_RUN_SHAPES),
          ("appendix B n=2048", 4, 2048, 64, 64, True),
          ("appendix B n=8192", 4, 8192, 64, 64, True),
          ("unaligned path", 8, 512, 512, 64, False)]
IDS = [s[0] for s in SHAPES]
#: SM counts: the H100's, and small cards
SMS = (132, 8, 1)


def test_constants_found():
    for name in ("kExpandThreads", "kExpandSpan", "kExpandWindow",
                 "kExpandWave", "kExpandMinThreads"):
        assert name in K, name
    s = K["kExpandSpan"]
    assert s & (s - 1) == 0 and s <= 32          # a power of two, <= a warp
    assert K["kExpandWindow"] >= 2
    assert K["kExpandMinThreads"] % 32 == 0


def test_shapes_cover_the_named_cases():
    got = {(b, n, d, r) for _, b, n, d, r, _ in SHAPES}
    assert {(8, 512, 512, 512), (8, 512, 512, 8), (4, 2048, 64, 64),
            (4, 8192, 64, 64)} <= got
    assert {d for _, b, n, d, r, vec in SHAPES if not vec} >= {33, 45, 512}


# ---------------------------------------------------------------- helpers
def expand_launch(b, n, d, sms, vec):
    """``interp_expand_f32``: (cols, qx, sy, slabs, grid blocks)."""
    span = K["kExpandSpan"]
    cols = d // 4 if vec else d
    qx = span
    while qx < 32 and qx < cols:
        qx *= 2
    sy = K["kExpandThreads"] // qx
    spans = -(-n // span)
    slabs = -(-cols // qx)
    while (qx * sy > K["kExpandMinThreads"]
           and -(-spans // sy) * slabs * b < K["kExpandWave"] * sms):
        sy //= 2
    return cols, qx, sy, slabs, -(-spans // sy) * slabs


def model(b, n, d, r, sms, vec):
    """Every thread of the launch, as numpy arrays over threads: its batch
    row, V column c, first row i0 and, for each of its span's rows j, the
    node lo[j] and weight w[j] it receives by shuffle and the nodes it
    reads. Returns a dict."""
    lo_all, w_all, _ = ref.hat_geometry(n, r)
    lo_all = lo_all.astype(np.int64)
    span, window = K["kExpandSpan"], K["kExpandWindow"]
    cols, qx, sy, slabs, blocks = expand_launch(b, n, d, sms, vec)
    bx, bi, ty, tx = (a.ravel() for a in np.meshgrid(
        np.arange(blocks), np.arange(b), np.arange(sy), np.arange(qx),
        indexing="ij"))
    sb = bx // slabs
    c = (bx - sb * slabs) * qx + tx
    i0 = (sb * sy + ty) * span
    # the rows each lane divides for, and the shuffle: row j of a thread
    # comes from lane group + j of its warp, group = (ty * qx) & 31
    lane_row = np.minimum(i0 + (tx & (span - 1)), n - 1)
    assert (lane_row >= 0).all()
    linear = ty * qx + tx
    lane = linear & 31
    group = (ty * qx) & 31
    assert np.array_equal(group, lane - tx)      # qx <= 32: aligned groups
    j = np.arange(span)
    src_linear = (linear - lane)[:, None] + group[:, None] + j[None, :]
    src_ty, src_tx = src_linear // qx, src_linear % qx
    # the source lanes are threads of the same block and the same span
    assert (src_linear < qx * sy).all()
    assert np.array_equal(src_ty, np.repeat(ty[:, None], span, 1))
    rows = np.minimum(i0[:, None] + j[None, :], n - 1)
    src = (np.arange(len(i0)) - tx)[:, None] + src_tx    # thread index
    assert np.array_equal(lane_row[src], rows)
    lo = lo_all[rows]
    w = w_all[rows]
    live = (c < cols) & (i0 < n)
    stored = live[:, None] & (i0[:, None] + j[None, :] < n)
    l0 = lo[:, 0]
    windowed = lo[:, -1] - l0 < window - 1
    kn = lo[:, -1] - l0 + 2
    return dict(cols=cols, qx=qx, sy=sy, slabs=slabs, blocks=blocks, bi=bi,
                c=c, i0=i0, lo=lo, w=w, live=live, stored=stored,
                windowed=windowed, kn=kn, l0=l0)


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label,b,n,d,r,vec", SHAPES, ids=IDS)
def test_launch_fits_and_fills(label, b, n, d, r, vec, sms):
    cols, qx, sy, slabs, blocks = expand_launch(b, n, d, sms, vec)
    threads = qx * sy
    assert K["kExpandMinThreads"] <= threads <= K["kExpandThreads"]
    assert qx & (qx - 1) == 0 and K["kExpandSpan"] <= qx <= 32
    assert 0 < blocks < 2 ** 31 and b <= 65535
    if threads > K["kExpandMinThreads"]:        # sy was not cut further
        assert blocks * b >= K["kExpandWave"] * sms
    if label == "path" and sms == 132 and K["kExpandSpan"] == 4:
        # 128 quads a row in 4 slabs of 32, 8 x 128 spans over 1,024
        # blocks of 128 threads: 7.8 blocks an SM, one wave
        assert (cols, qx, sy, slabs, blocks * b) == (128, 32, 4, 4, 1024)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label,b,n,d,r,vec", SHAPES, ids=IDS)
def test_every_output_written_once(label, b, n, d, r, vec, sms):
    m = model(b, n, d, r, sms, vec)
    lanes = 4 if vec else 1
    count = np.zeros((b, n, m["cols"]), np.int64)
    t, j = np.nonzero(m["stored"])
    np.add.at(count, (m["bi"][t], m["i0"][t] + j, m["c"][t]), 1)
    assert (count == 1).all()
    assert m["cols"] * lanes == d


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label,b,n,d,r,vec", SHAPES, ids=IDS)
def test_rows_nodes_in_the_window(label, b, n, d, r, vec, sms):
    m = model(b, n, d, r, sms, vec)
    live, win = m["live"], m["windowed"]
    lo, l0, kn = m["lo"], m["l0"], m["kn"]
    w = K["kExpandWindow"]
    # the window route: the nodes l0 .. l0 + kn - 1 (kn <= window) are read
    # once each and every row's pair lies in them, at k = lo - l0 and k + 1
    t = live & win
    assert (kn[t] <= w).all() and (kn[t] >= 2).all()
    assert (l0[t] + kn[t] <= r).all()              # every node read exists
    k = lo[t] - l0[t][:, None]
    assert (k >= 0).all() and (k + 1 < kn[t][:, None]).all()
    assert (k <= w - 2).all()                      # the selects' reach
    # the other route reads each row's own pair
    t = live & ~win
    assert (lo[t] >= 0).all() and (lo[t] + 1 < r).all()
    if r >= 8 and n / max(r - 1, 1) >= 2 * K["kExpandSpan"]:
        assert win[live].all()                    # h >= 2 spans: all windowed
    full = live & (m["i0"] + K["kExpandSpan"] <= n)
    if r == n and K["kExpandSpan"] + 1 > w:
        assert not win[full].any()                # a node a row
    # node rows read from z a span: at most kExpandWindow on the window
    # route; at the path at most half of the two a row that the parent
    # kernel read
    if label in ("path", "run path"):
        reads = np.where(win[live], kn[live], 2 * K["kExpandSpan"])
        assert reads.max() <= w
        assert reads.sum() <= 0.5 * 2 * K["kExpandSpan"] * live.sum()


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("label,b,n,d,r,vec", SHAPES, ids=IDS)
def test_modelled_y_is_the_reference(label, b, n, d, r, vec, sms):
    m = model(b, n, d, r, sms, vec)
    lanes = 4 if vec else 1
    z = np.random.default_rng(0).standard_normal((b, r, d))
    y = np.full((b, n, d), np.nan)
    t, j = np.nonzero(m["stored"])
    lo, l0, kn = m["lo"][t, j], m["l0"][t], m["kn"][t]
    win = m["windowed"][t]
    # the window route as the kernel runs it: slot s holds node l0 + s for
    # s < kn (else slot s - 1's node); the row takes slots (q, q + 1) with
    # q = lo - l0 where 1 <= q <= kExpandWindow - 2, else (0, 1)
    k = lo - l0
    q = np.where((k >= 1) & (k <= K["kExpandWindow"] - 2), k, 0)
    a = np.where(win, l0 + np.minimum(q, kn - 1), lo)
    b_node = np.where(win, l0 + np.minimum(q + 1, kn - 1), lo + 1)
    wl = m["w"][t, j].astype(np.float32)
    wh = np.float32(1.0) - wl
    bi, i = m["bi"][t], m["i0"][t] + j
    for q in range(lanes):
        ch = m["c"][t] * lanes + q
        y[bi, i, ch] = (wl.astype(np.float64) * z[bi, a, ch]
                        + wh.astype(np.float64) * z[bi, b_node, ch])
    want = np.einsum("nr,brd->bnd",
                     ref.hat_interp_matrix(n, r).double().numpy(), z)
    assert not np.isnan(y).any()
    assert np.abs(y - want).max() <= 1e-12 * np.abs(want).max()
