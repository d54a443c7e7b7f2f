"""The error budget of the bf16 ``ssd_scan`` CUDA kernel, on the CPU.

The kernel (``src/repro_torch/kernels/csrc/ssd_scan.cu``) runs C Bᵀ as a
bf16 tensor-core product (exact products, fp32 sums) and scores · X,
C Sᵀ and (X ⊙ w)ᵀ B as TF32 ones: the scores, the carried state and
X ⊙ w are rounded to TF32 (to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` rounds; the kernel does it with an integer add and
mask), every sum is fp32, and y rounds once to bf16. The state itself
stays fp32; only the copy C Sᵀ reads is rounded. ``_kernel_emulation``
repeats those roundings in plain torch (a helper of this test, not of the
package), so the tolerance the card is held to is shown here before any
card run. Its exponentials are torch's; the kernel's ``ex2.approx.ftz``
differs by about 2^-22 relative, far under TF32's rounding.

Tolerances, each with its reason:
* the emulation against the port's plain version
  (``ssd_chunked.ssd_scan_chunked``) and against the JAX package's
  (``ssd_scan_pallas`` in interpret mode where n is a multiple of the
  chunk, which it asserts, else ``ssd_chunked.ssd_scan_chunked``):
  ``chip_smoke.BF16_TOL`` = 1e-2 × max|y|, the tier ``chip_smoke.py``
  holds the kernel to on the card (both sides round y to bf16 once: at
  most one bf16 ulp of an element apart, 2^-7 × max at worst, plus the
  TF32 error below);
* the emulation before its rounding to bf16, against the float64 oracle
  ``ref.ssd_scan_ref``: 2e-3 × max|y|. TF32 keeps 11 significant bits
  (2^-12 relative a rounding); a sum of q ≤ 128 such terms of both signs
  stays near 1e-3 of the largest output at worst. This is the headroom
  the bf16 tier keeps.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ssd_chunked as jssd  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro_torch.kernels import ref, ssd_chunked  # noqa: E402

#: chip_smoke.BF16_TOL (the script lives at the repository's root)
BF16_TOL = 1e-2
TF32_TOL = 2e-3

# (bt, n, h, p, g, s, chunk): a ragged n, n < q, n = 1, g = 2 and 4,
# p = 8 and s = 8, the Mamba path's widths (p 64, s 128, q 128), and rows
# that the kernel loads element by element
SHAPES = [(2, 100, 4, 8, 1, 8, 32),       # ragged: 100 = 3 x 32 + 4
          (2, 20, 4, 16, 2, 16, 32),      # n < q, g = 2
          (2, 1, 4, 8, 4, 8, 16),         # n = 1, g = 4
          (1, 96, 4, 8, 4, 8, 32),        # g = 4, whole chunks
          (2, 128, 4, 16, 2, 16, 32),     # g = 2, whole chunks
          (1, 256, 2, 64, 1, 128, 128),   # the path's p, s and q
          (1, 70, 4, 6, 2, 12, 32)]       # p, s not multiples of 8


def _inputs(bt, n, h, p, g, s, seed):
    """numpy fp32 inputs as ``chip_smoke._ssd_inputs`` draws them: x, B,
    C ~ N(0, 1) (rounded to bf16 by the callers), dt = softplus(N(0, 1) -
    3), a = -exp(0.1 N(0, 1)), D = 1 + 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, n, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, n, h)) - 3.0))
    a = -np.exp(0.1 * rng.standard_normal(h))
    b = rng.standard_normal((bt, n, g, s)).astype(np.float32)
    c = rng.standard_normal((bt, n, g, s)).astype(np.float32)
    dsk = 1.0 + 0.1 * rng.standard_normal(h)
    return (x, dt.astype(np.float32), a.astype(np.float32), b, c,
            dsk.astype(np.float32))


def _tf32(t):
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: half of the 13 dropped bits added
    to the magnitude, then the 13 bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _kernel_emulation(x, dt, a, b, c, d_skip, chunk, out_dtype=None):
    """The kernel's arithmetic in plain torch: chunks of q = min(chunk, n)
    positions, the last one ragged; C Bᵀ exact in fp32; the scores, the
    state and X ⊙ w rounded to TF32 where a product reads them; fp32
    sums; y in ``out_dtype`` (x's by default)."""
    bt, n, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    q, hpg = min(chunk, n), h // g
    xf, bf, cf = x.float(), b.float(), c.float()
    state = torch.zeros(bt, h, p, s)
    y = torch.empty(bt, n, h, p)
    for t0 in range(0, n, q):
        nv = min(q, n - t0)
        xc = xf[:, t0:t0 + nv]                                 # (bt,j,h,p)
        bc = bf[:, t0:t0 + nv].repeat_interleave(hpg, dim=2)   # (bt,j,h,s)
        cc = cf[:, t0:t0 + nv].repeat_interleave(hpg, dim=2)
        dtc = dt[:, t0:t0 + nv]                                # (bt,j,h)
        cum = torch.cumsum(dtc * a, dim=1)
        clast = cum[:, -1]                                     # (bt,h)
        seg = cum.transpose(1, 2)[..., :, None] - cum.transpose(1, 2)[
            ..., None, :]                                      # (bt,h,i,j)
        tri = torch.tril(torch.ones(nv, nv, dtype=torch.bool))
        decay = torch.exp(torch.where(tri, seg, float("-inf")))
        cb = torch.einsum("bihs,bjhs->bhij", cc, bc)
        scores = _tf32(cb * decay * dtc.transpose(1, 2)[..., None, :])
        y_intra = torch.einsum("bhij,bjhp->bihp", scores, xc)
        y_inter = torch.einsum("bihs,bhps->bihp", cc, _tf32(state)) * \
            torch.exp(cum)[..., None]
        y[:, t0:t0 + nv] = y_inter + y_intra + xc * d_skip[:, None]
        w = torch.exp(clast[:, None] - cum) * dtc              # (bt,j,h)
        xw = _tf32(xc * w[..., None])
        state = state * torch.exp(clast)[..., None, None] + torch.einsum(
            "bjhp,bjhs->bhps", xw, bc)
    return y.to(out_dtype or x.dtype)


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _both(arrs):
    """x, B, C in bf16 for both packages (one rounding, the same), dt, a,
    D fp32."""
    low = (0, 3, 4)
    jx = [jnp.asarray(v).astype(jnp.bfloat16) if i in low else jnp.asarray(v)
          for i, v in enumerate(arrs)]
    tx = [torch.from_numpy(v).bfloat16() if i in low else torch.from_numpy(v)
          for i, v in enumerate(arrs)]
    return jx, tx


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's ulp at 1
    t = torch.tensor([one, one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0e-3], dtype=torch.float32)
    got = _tf32(t)
    assert got[:5].tolist() == [one, one, one + ulp, one + ulp,
                                -(one + ulp)]
    assert got[5].item() == pytest.approx(3.0e-3, rel=2.0 ** -11)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("bt,n,h,p,g,s,chunk", SHAPES)
def test_kernel_roundings_within_bf16_tier(bt, n, h, p, g, s, chunk):
    jx, tx = _both(_inputs(bt, n, h, p, g, s, seed=n + 7 * g))
    got = _kernel_emulation(*tx, chunk)
    assert got.dtype == torch.bfloat16 and got.shape == (bt, n, h, p)
    want = ssd_chunked.ssd_scan_chunked(*tx, chunk=chunk)
    _close(got.float(), want.float(), BF16_TOL, "vs ssd_scan_chunked")
    if n % min(chunk, n) == 0:
        jwant = ssd_scan_pallas(*jx, chunk=min(chunk, n), interpret=True)
        what = "vs JAX ssd_scan_pallas (interpret)"
    else:
        jwant = jssd.ssd_scan_chunked(*jx, chunk=chunk)
        what = "vs JAX ssd_scan_chunked"
    _close(got.float(), np.asarray(jnp.asarray(jwant, jnp.float32)),
           BF16_TOL, what)


@pytest.mark.parametrize("bt,n,h,p,g,s,chunk", SHAPES)
def test_tf32_error_before_bf16_rounding(bt, n, h, p, g, s, chunk):
    """The TF32 roundings alone, against the float64 oracle on the same
    (bf16-valued) inputs: the headroom under the bf16 tier."""
    _, tx = _both(_inputs(bt, n, h, p, g, s, seed=n + 7 * g))
    got = _kernel_emulation(*tx, chunk, out_dtype=torch.float32)
    want = ref.ssd_scan_ref(*(t.double() for t in tx))
    _close(got, want, TF32_TOL, "TF32 emulation vs float64 ssd_scan_ref")


def _repo_module(rel):
    """A module of the repository outside the packages (the smoke script,
    a tool), loaded from its file."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        Path(rel).stem, root / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_markers_instrument_the_bf16_kernel():
    """tools/ssd_scan_phases.py stamps the kernel at its ``// phase:``
    comments: each is in the source once, inside the bf16 kernel, and
    every one becomes a stamp or the write-out."""
    tool = _repo_module("tools/ssd_scan_phases.py")
    from repro_torch.kernels import backend
    src = backend.SOURCES["ssd_scan"].read_text()
    out = tool.instrument(src)
    assert not re.search(r"^\s*// phase:", out, re.M)
    kernel = out[out.index("ssd_scan_bf16_kernel(const"):
                 out.index("// -------------------------------------------"
                           "----------------- launchers")]
    assert kernel.count("clock64()") == len(tool.PHASES) + 1
    assert kernel.count("g_prof[") == 1
    assert out.count("clock64()") == len(tool.PHASES) + 1


def test_ssd_bound_prices_each_product_at_its_type():
    """chip_smoke's bf16 bound at the Mamba path shape: C Bᵀ at the bf16
    tensor-core peak, the three products with an fp32 operand at the TF32
    one; the chunked count as a whole is unchanged by the split."""
    smoke = _repo_module("chip_smoke.py")
    nbytes, tf32, cb, fewer = smoke._ssd_cost(8, 2048, 80, 64, 1, 128, 128,
                                              2)
    rows = 2048 // 128
    assert cb == rows * 128 * 129 * 128 * 8
    assert tf32 == rows * (128 * 129 * 64 + 4 * 128 * 128 * 64) * 8 * 80
    assert fewer == 5 * 64 * 128 * 2048 * 8 * 80
    bw, _, peak_tf32, peak_bf16 = smoke.PEAKS["H100"]
    bound = max(nbytes / bw, tf32 / peak_tf32 + cb / peak_bf16) * 1e3
    assert bound == pytest.approx(0.109, abs=5e-4)
