#!/usr/bin/env python3
"""Write the ablation and tuning builds of ``interp_expand`` that
``PERF.md`` times, as copies of a ``csrc/ski.cu`` with one edit each.

    python3 tools/interp_expand_variants.py PARENT.cu [--out build/ab]

``PARENT.cu`` is the source before the span redesign (``git show
<rev>:src/repro_torch/kernels/csrc/ski.cu``): a block of 8 rows whose
threads sweep the rows' channel quads with a 64-bit loop index, each
quad loading its two nodes. Its ablations, which no longer compute the
function (time them with ``tools/ab_kernel.py ski --time-only``):

* ``ie_idx32``: the loop's index and division in 32 bits;
* ``ie_stores``: no loads of z, the weights stored in their place;
* ``ie_pair8``: each thread's node pair loaded once, before the loop,
  for all 8 rows (the pair of the block's first row).

From the current source, tuning builds of the span design, which compute
the function (``tools/ab_kernel.py ski`` checks them): ``ie_span2``,
``ie_span4``, ``ie_span8`` and ``ie_span16`` (``kExpandSpan``),
``ie_wave1`` (``kExpandWave``: one block an SM) and ``ie_plainst`` (y
stored by plain stores, not ``__stcs``). Prints the paths written;
raises if an edit does not match exactly once.
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CURRENT = ROOT / "src/repro_torch/kernels/csrc/ski.cu"

_LOOP = """    const long long d4 = d / 4;
    for (long long e = threadIdx.x; e < rows * d4; e += kExpandThreads) {
      const int q = (int)(e / d4);
      const long long c4 = e - q * d4;
"""
_LOADS = """      const float4 a = __ldg(reinterpret_cast<const float4*>(
                                 zb + slo[q] * d) + c4);
      const float4 b = __ldg(reinterpret_cast<const float4*>(
                                 zb + (slo[q] + 1) * d) + c4);
"""

_LOOP32 = """    const int d4 = (int)(d / 4);
    for (int e = threadIdx.x; e < rows * d4; e += kExpandThreads) {
      const int q = e / d4;
      const int c4 = e - q * d4;
"""
_NO_LOADS = """      const float4 a = make_float4(wl, wh, wl, wh);
      const float4 b = make_float4(wh, wl, wh, wl);
"""
_PAIR_AHEAD = """    const long long d4 = d / 4;
    const long long c40 = threadIdx.x % d4;
    const float4 a = __ldg(reinterpret_cast<const float4*>(
                               zb + slo[0] * d) + c40);
    const float4 b = __ldg(reinterpret_cast<const float4*>(
                               zb + (slo[0] + 1) * d) + c40);
    for (long long e = threadIdx.x; e < rows * d4; e += kExpandThreads) {
      const int q = (int)(e / d4);
      const long long c4 = e - q * d4;
"""
_KERNEL = ("template <typename V>\n"
           "__global__ void __launch_bounds__(kExpandThreads)")


def _constant(name: str, value: int):
    """The edit that sets ``constexpr int name`` to ``value``."""
    return (rf"constexpr int {name} = \d+;",
            f"constexpr int {name} = {value};")


#: name -> (source: "parent" or "current", [(regular expression, new
#: text), ...])
VARIANTS = {
    "ie_idx32": ("parent", [(re.escape(_LOOP), _LOOP32)]),
    "ie_stores": ("parent", [(re.escape(_LOADS), _NO_LOADS)]),
    "ie_pair8": ("parent", [(re.escape(_LOOP), _PAIR_AHEAD),
                            (re.escape(_LOADS), "")]),
    **{f"ie_span{span}": ("current", [_constant("kExpandSpan", span)])
       for span in (2, 4, 8, 16)},
    "ie_wave1": ("current", [_constant("kExpandWave", 1)]),
    "ie_plainst": ("current", [(
        re.escape(_KERNEL), "#define __stcs(p, v) (*(p) = (v))\n" + _KERNEL)]),
}


def variant(text: str, edits) -> str:
    """``text`` with each (pattern, new) edit applied; each pattern must
    match exactly once."""
    for pat, new in edits:
        text, count = re.subn(pat, lambda _: new, text)
        if count != 1:
            raise ValueError(f"edit does not match once: {pat[:60]!r}")
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab")
    args = ap.parse_args()
    sources = {"parent": args.parent.read_text(),
               "current": CURRENT.read_text()}
    args.out.mkdir(parents=True, exist_ok=True)
    for name, (src, edits) in VARIANTS.items():
        path = args.out / f"{name}.cu"
        path.write_text(variant(sources[src], edits))
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
