"""The arithmetic of the tensor-core ``ski_windowed_pass2`` CUDA kernel, on
the CPU.

The kernel (``src/repro_torch/kernels/csrc/ski.cu``, ``gram_window_tc``)
computes each sequence tile's window of z₂ = A z from the (d, 2r-1)
Toeplitz coefficients with ``mma.m16n8k8`` TF32 products: window rows in
m-tiles of 16 (padded past bw; a channel's first 5 m-tiles to one warp,
the rest to another), z rows in k-steps of 8, stages of 128 z rows, and
every operand split once
into TF32 halves, v = hi + lo, hi = rna(v) and lo = rna(v - hi) (to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``), summed as
hi·hi + hi·lo + lo·hi in fp32 ("3xTF32"). A warp builds its A fragments
from a register window over the coefficient line, because a Toeplitz tile
depends on its diagonal alone. ``_kernel_model`` repeats that arithmetic
in plain torch (a helper of this test, never on the package's path), its
fragments gathered by the same window indices the kernel reads, so the
tier the card is held to is shown here before any card run.

Tolerances, each with its reason:
* the model against a float64 dense Toeplitz product and against the
  plain versions (the port's ``ref.toeplitz_gram_matvec_ref``, an rfft
  Gram, and the JAX package's): ``_window_tol(r)`` × max|y|, the tier
  ``chip_smoke._window_tol`` holds the kernel to on the card (1e-5 to
  r = 512, 1e-4 beyond: sums of r terms in another order). 3xTF32 keeps
  about 21 significant bits a product, close to fp32's 24;
* one TF32 product (hi·hi alone, 11 significant bits) at r = 512 must
  miss the 1e-5 tier: the reason the kernel pays for three;
* the window indices compare exactly (integers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import backend, ref  # noqa: E402
from test_torch_ssd_scan import _repo_module  # noqa: E402

torch.set_num_threads(1)

#: the kernel's constants (csrc/ski.cu): z rows of a stage, its k-steps of
#: 8 rows, m-tiles of a window at most
STAGE_T, MAX_MT = 128, 9
STEPS = STAGE_T // 8


#: chip_smoke.py, which holds the kernel to its tier on the card
SMOKE = _repo_module("chip_smoke.py")
_window_tol = SMOKE._window_tol


def _tf32(t):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel's ``tf32_rna``: half of the 13 dropped bits
    added to the magnitude, then the 13 bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _gram_mt(bw: int) -> int:
    """The kernel's ``gram_mt``: 3 m-tiles for windows of 48 rows or fewer,
    else 9."""
    mt = -(-bw // 16)
    assert mt <= MAX_MT
    return 3 if mt <= 3 else MAX_MT


def _halves(mt: int):
    """(m0, nm) of the two warps of a channel: m-tiles [0, (mt + 1) / 2)
    and the rest."""
    return ((0, (mt + 1) // 2), ((mt + 1) // 2, mt // 2))


def _fragment_slots(nm: int, m0: int, ks: int):
    """(16 nm, 8) stage coefficient slots of the A operand of k-step ks of
    the warp whose m-tiles are m0 .. m0 + nm - 1, built lane by lane from
    the kernel's register window: lane (g, t4) holds w[i] = slot e0 + 4 i
    with e0 = 16 m0 + 3 + g - t4, and m-tile mi's fragment is (a0, a1, a2,
    a3) = w[q], w[q + 2], w[q - 1], w[q + 1] at rows (g, g + 8, g, g + 8)
    and columns (t4, t4, t4 + 4, t4 + 4), q = 4 mi - 2 ks + 2 STEPS - 1.
    Also returns the window indices the k-step reads."""
    slots = np.full((16 * nm, 8), -1, dtype=np.int64)
    used = set()
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        e0 = 16 * m0 + 3 + g - t4
        for mi in range(nm):
            q = 4 * mi - 2 * ks + 2 * STEPS - 1
            for i, (row, col) in zip((q, q + 2, q - 1, q + 1),
                                     ((g, t4), (g + 8, t4), (g, t4 + 4),
                                      (g + 8, t4 + 4))):
                slots[16 * mi + row, col] = e0 + 4 * i
                used.add(i)
    return slots, used


def _kernel_model(x, z, coef, f, left, tn, bw, products=3):
    """The kernel's arithmetic: x (b, n, d), z (b, r, d), coef (d, 2r-1),
    f (d, m) fp32 → y (b, n, d). ``products`` 3 is the kernel's 3xTF32,
    2 its bf16 instance's (hi·hi and lo·hi: a bf16 z has no lo half), 1 a
    single TF32 product (hi·hi)."""
    b, n, d = x.shape
    r = z.shape[1]
    mt = _gram_mt(bw)
    span = 16 * mt + STAGE_T
    lo, w_lo, _ = ref.hat_geometry(n, r)
    tiles = -(-n // tn)
    # the window rule: the node of the tile's first row, clamped to r - bw
    w0 = np.minimum(lo[np.arange(tiles) * tn], max(r - bw, 0))
    ncoef = 2 * r - 1
    acc = torch.zeros(tiles, d, 16 * mt, b)
    for s in range(-(-r // STAGE_T)):
        # the stage: z rows 128 s .., coefficient slots base ..
        zs = torch.zeros(b, STAGE_T, d)
        rows = min(STAGE_T, r - STAGE_T * s)
        zs[:, :rows] = z[:, STAGE_T * s:STAGE_T * s + rows]
        idx = (w0 + r - STAGE_T - STAGE_T * s)[:, None] + np.arange(span)
        ok = torch.from_numpy((idx >= 0) & (idx < ncoef))
        cs = coef[:, torch.from_numpy(np.clip(idx, 0, ncoef - 1))]
        cs = torch.where(ok[None], cs, 0.0).transpose(0, 1)  # (tiles, d, e)
        zh, csh = _tf32(zs), _tf32(cs)
        zl, csl = _tf32(zs - zh), _tf32(cs - csh)
        frags = []
        for ks in range(STEPS):               # both warps' m-tiles, stacked
            sl = torch.from_numpy(np.concatenate(
                [_fragment_slots(nm, m0, ks)[0] for m0, nm in _halves(mt)]))
            frags.append((csh[..., sl], csl[..., sl], 8 * ks))
        for ah, _, t0 in frags:                          # hi.hi, hi.lo
            bh = zh[:, t0:t0 + 8].permute(2, 1, 0)       # (d, k, b)
            acc = acc + torch.einsum("tdjk,dkb->tdjb", ah, bh)
            if products == 3:
                bl = zl[:, t0:t0 + 8].permute(2, 1, 0)
                acc = acc + torch.einsum("tdjk,dkb->tdjb", ah, bl)
        if products >= 2:                                # lo.hi
            for _, al, t0 in frags:
                bh = zh[:, t0:t0 + 8].permute(2, 1, 0)
                acc = acc + torch.einsum("tdjk,dkb->tdjb", al, bh)
    z2w = acc[:, :, :bw]                                 # (tiles, d, bw, b)
    # expansion from the window, then the conv: y = low + conv
    tile = np.arange(n) // tn
    j = lo - w0[tile]
    assert j.min() >= 0 and j.max() + 1 < bw
    jt, tt = torch.from_numpy(j), torch.from_numpy(tile)
    za = z2w[tt, :, jt].permute(2, 0, 1)                 # (b, n, d)
    zb = z2w[tt, :, jt + 1].permute(2, 0, 1)
    wl = torch.from_numpy(w_lo)[None, :, None]
    low = wl * za + (1.0 - wl) * zb
    return low + ref._shift_conv(x, f, left)


def _float64(x, z, coef, f, left):
    """y in float64: the dense Toeplitz Gram (one channel's (r, r) panel at
    a time), the dense W, shifted adds."""
    b, n, d = x.shape
    r, m = z.shape[1], f.shape[1]
    k = torch.arange(r)
    lag = k[:, None] - k[None, :] + r - 1
    z2 = torch.empty(b, r, d, dtype=torch.float64)
    for ch in range(d):
        z2[:, :, ch] = z[:, :, ch].double() @ coef[ch].double()[lag].T
    lo, w_lo, _ = ref.hat_geometry(n, r)
    w = ref.dense_interp_matrix(torch.from_numpy(lo), torch.from_numpy(w_lo),
                                r).double()
    want = torch.einsum("nr,brd->bnd", w, z2)
    xp = torch.nn.functional.pad(x.double(), (0, 0, m - 1 - left, left))
    for t in range(m):
        want += xp[:, m - 1 - t:m - 1 - t + n] * f[:, t].double()
    return want


def _inputs(b, n, d, r, m, seed):
    """As ``chip_smoke.phase_window_kernels`` draws them: x, z, f ~ N(0, 1),
    the coefficients N(0, 1) / sqrt(r); numpy, so both packages get the
    same numbers."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    z = rng.standard_normal((b, r, d)).astype(np.float32)
    coef = (rng.standard_normal((d, 2 * r - 1)) / np.sqrt(r)).astype(
        np.float32)
    f = rng.standard_normal((d, m)).astype(np.float32)
    return x, z, coef, f


# (label, b, n, d, r, m, left, band max): the large-rank path narrowed to
# d = 16 (bw = 136, 8 past a multiple of 16) with causal and bidirectional
# taps, r = 181 (bw = 56), r < 16 with r < bw, r = 2, r = 4097 (33 stages,
# 1e-4 tier), and the 16-wide band of REPRO_SKI_BAND_MAX=16 (8-row tiles)
SHAPES = [("path", 8, 512, 16, 512, 32, 0, None),
          ("path bidirectional", 8, 512, 16, 512, 32, 16, None),
          ("r=181", 8, 512, 16, 181, 32, 16, None),
          ("r<16", 2, 40, 8, 11, 4, 2, None),
          ("r=2", 2, 40, 8, 2, 8, 3, None),
          ("r=4097", 2, 4099, 16, 4097, 32, 3, None),
          ("band 16", 8, 512, 16, 512, 32, 16, "16")]


@pytest.mark.parametrize("label,b,n,d,r,m,left,band", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_kernel_model_within_window_tier(label, b, n, d, r, m, left, band,
                                         monkeypatch):
    if band is not None:
        monkeypatch.setenv("REPRO_SKI_BAND_MAX", band)
    tn, bw = backend.band_fit(128, n, r)
    if band is not None:
        assert bw <= int(band) and tn < 128
    xn, zn, cn, fn = _inputs(b, n, d, r, m, seed=r + left)
    x, z, coef, f = map(torch.from_numpy, (xn, zn, cn, fn))
    got = _kernel_model(x, z, coef, f, left, tn, bw)
    want64 = _float64(x, z, coef, f, left)
    tol = _window_tol(r)
    scale = float(want64.abs().max())
    err64 = float((got.double() - want64).abs().max())
    assert err64 <= tol * scale, (err64, scale)
    # the plain versions: the port's rfft Gram and the JAX package's
    plain = ref.ski_expand_pass2_ref(x, ref.toeplitz_gram_matvec_ref(coef, z),
                                     f, True, left=left)
    jplain = np.array(jref.ski_expand_pass2_ref(
        jnp.asarray(xn), jref.toeplitz_gram_matvec_ref(jnp.asarray(cn),
                                                       jnp.asarray(zn)),
        jnp.asarray(fn), True, left=left))
    for other in (plain, torch.from_numpy(jplain)):
        err = float((got - other).abs().max())
        assert err <= tol * float(other.abs().max()), (err, label)


@pytest.mark.parametrize("products", [1, 3])
def test_one_tf32_product_misses_the_tier(products):
    """At the path's r = 512 (narrowed to d = 16) one TF32 product misses
    1e-5 × max, and the kernel's three meet it with room to spare."""
    b, n, d, r, m, left = 8, 512, 16, 512, 32, 0
    tn, bw = backend.band_fit(128, n, r)
    x, z, coef, f = map(torch.from_numpy, _inputs(b, n, d, r, m, seed=3))
    got = _kernel_model(x, z, coef, f, left, tn, bw, products=products)
    want = _float64(x, z, coef, f, left)
    err = float((got.double() - want).abs().max())
    limit = _window_tol(r) * float(want.abs().max())
    if products == 1:
        assert err > limit, (err, limit)
    else:
        assert err <= limit / 10, (err, limit)


@pytest.mark.parametrize("mt", [3, MAX_MT])
@pytest.mark.parametrize("half", [0, 1])
def test_fragment_window_is_the_toeplitz_panel(mt, half):
    """The register window's slots are the Toeplitz panel's: A[j, t] of
    stage row t = 8 ks + col sits in slot j - t + 127; m-tile mi + 1 at
    k-step ks + 2 repeats m-tile mi at ks; every slot lies in the stage's
    span; the first k-step reads window indices 2 STEPS - 2 .. 4 nm +
    2 STEPS - 3 and each later one two below what came before, so the rest
    carry over in registers."""
    m0, nm = _halves(mt)[half]
    span = 16 * mt + STAGE_T
    seen = set()
    for ks in range(STEPS):
        slots, used = _fragment_slots(nm, m0, ks)
        j = 16 * m0 + np.arange(16 * nm)[:, None]
        t = 8 * ks + np.arange(8)[None, :]
        np.testing.assert_array_equal(slots, j - t + STAGE_T - 1)
        assert slots.min() >= 0 and slots.max() < span
        if ks + 2 < STEPS and nm > 1:
            nxt, _ = _fragment_slots(nm, m0, ks + 2)
            np.testing.assert_array_equal(nxt[16:], slots[:-16])
        loads = (set(range(2 * STEPS - 2, 4 * nm + 2 * STEPS - 2)) if ks == 0
                 else {2 * STEPS - 2 - 2 * ks, 2 * STEPS - 1 - 2 * ks})
        assert not loads & seen
        seen |= loads
        assert used <= seen


def test_tf32_split_rounds_to_nearest_away():
    """hi = rna(v) keeps 10 mantissa bits, ties away from zero; hi + lo
    recovers v to about 2^-22 relative."""
    v = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23, 3.0], dtype=torch.float32)
    hi = _tf32(v)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    wh = _tf32(w)
    wl = _tf32(w - wh)
    assert float(((wh + wl - w).abs() / w.abs()).max()) <= 2.0 ** -21
    assert bool(((wh.view(torch.int32) & 0x1FFF) == 0).all())


def test_windowed_bound_prices_the_gram_at_three_tf32_products():
    """chip_smoke's bound of ski_windowed_pass2 at the large-rank path's
    shape, x (8, 512, 512), r = 512, m = 32: the Gram's 2·b·d·r² flops
    three times over at the TF32 peak (13.0 µs) on the tensor cores; the
    conv and expansion at the fp32 peak (2.1 µs) on the CUDA cores, which
    run beside them; so 13.0 µs, above the bytes' 8.16 µs. All of it at
    the fp32 peak, the bound before the tensor cores, was 34.2 µs."""
    smoke = SMOKE
    nbytes, gram, rest = smoke._windowed_cost(8, 512, 512, 512, 32)
    bw, fp32, tf32, _ = smoke.PEAKS["H100"]
    assert nbytes == 27_326_464 and gram == 2_147_483_648
    assert 3 * gram / tf32 * 1e3 == pytest.approx(0.01301, abs=1e-5)
    assert rest / fp32 * 1e3 == pytest.approx(0.00213, abs=1e-5)
    assert nbytes / bw * 1e3 == pytest.approx(0.00816, abs=1e-5)
    assert (gram + rest) / fp32 * 1e3 == pytest.approx(0.03418, abs=1e-5)
    bound, by = smoke._bound(nbytes, ((3 * gram, tf32, "tensor cores"),
                                      (rest, fp32, "cuda cores")),
                             smoke.PEAKS["H100"])
    assert by == "operations" and bound == 3 * gram / tf32 * 1e3
