"""Streaming overlap-save decode for causal FD mixers, counterpart of
``repro/kernels/fd_stream.py`` (plain torch ops: the JAX module is plain
jnp, not Pallas).

The cache holds a ring of the last C tokens and precomputed kernel-tail
contributions: a token's output is the masked (d, C) head product over the
ring plus its tail entry, O(C·d) per token; when a block of C tokens
retires, one length-2C rfft caches its spectrum and the tail of the next C
positions is refreshed from all retired blocks' spectra against the kernel
segment spectra (one length-2C irfft). The decode is the exact causal
Toeplitz action, up to fp accumulation order. Spectra are fp32 re/im
planes, the JAX leaf layout.

``stream_step`` takes either one int position (every row in lockstep,
the solo decode loop) or one position per row (the continuous-batching
engine: each slot at its own ring phase and block index). The int is the
per-row form broadcast, so lockstep and ragged decode give the same bits
per row. Per-row positions are host values (:class:`Positions` keeps them
beside their device copy): whether any row completes a block is decided
on the host, so a step adds no device-to-host sync, and the boundary
refresh runs only when some row is at a boundary and changes only those
rows. Cache updates are functional, as in JAX: a step returns a new dict and
leaves its input unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def stream_block_size(cache: dict) -> int:
    """C of a streaming cache (ring is (b, C, d))."""
    return cache["ring"].shape[1]


def is_stream_cache(cache) -> bool:
    return isinstance(cache, dict) and "ring" in cache


def stream_capacity(cache: dict) -> int:
    """Slot capacity (max positions) of a streaming cache: the leading
    dim of the zero-element ``cap`` marker. A position at or past it
    would index past the ``uspec`` block table."""
    return cache["cap"].shape[0]


class Positions(NamedTuple):
    """Per-row decode positions: ``host`` (b,) int64 numpy for the
    host-side decisions (block boundaries), ``dev`` (b,) int64 on the
    cache's device for the arithmetic. One per decode step, shared by
    every layer."""
    host: np.ndarray
    dev: torch.Tensor


def positions(t, b: int, device) -> Positions:
    """``t`` as :class:`Positions` of ``b`` rows: an int (every row at
    ``t``), a host sequence or CPU tensor of b positions, or Positions
    (returned as they are). A device tensor raises: reading it would
    sync."""
    if isinstance(t, Positions):
        return t
    if isinstance(t, (int, np.integer)):
        host = np.full((b,), int(t), np.int64)
        return Positions(host, torch.full((b,), int(t), dtype=torch.long,
                                          device=device))
    if isinstance(t, torch.Tensor) and t.device.type != "cpu":
        raise ValueError("per-row positions must be host values (a list, "
                         f"numpy array or CPU tensor), got a {t.device} "
                         "tensor")
    host = np.array(t, dtype=np.int64).reshape(-1)
    if host.shape != (b,):
        raise ValueError(f"{host.shape[0]} positions for {b} rows")
    if host.min() < 0:
        raise ValueError(f"negative position in {host.tolist()}")
    return Positions(host, torch.from_numpy(host).to(device))


def fd_stream_cache(k_causal: torch.Tensor, batch: int, max_len: int,
                    C: int) -> dict:
    """Build the overlap-save cache for one causal-TNO layer.

    k_causal: (d, L) time-domain causal kernel, lags 0..L-1, L >= max_len.
    Leaves (as in JAX): ring/tail (b, C, d); uspec_re/im (b, NB, F, d) with
    F = C+1 and NB = ceil(max_len / C); khead (d, C); khs_re/im (F, d);
    kseg_re/im (NB, F, d); cap (max_len, 0).
    """
    d, ll = k_causal.shape
    if ll < max_len:
        raise ValueError(f"kernel covers {ll} lags < max_len={max_len}")
    nb = -(-max_len // C)                                  # retired blocks
    k = k_causal.float()
    dev = k.device
    khead = k[:, :C]                                       # lags 0..C-1
    khs = torch.fft.rfft(khead, n=2 * C, dim=-1)           # (d, F)
    # age-m segment: lags (m-1)C+1 .. (m+1)C-1 (2C-1 taps, zero past L)
    kp = torch.nn.functional.pad(k, (0, (nb + 1) * C))
    segs = torch.stack([kp[:, (m - 1) * C + 1:(m + 1) * C]
                        for m in range(1, nb + 1)], dim=0)  # (nb, d, 2C-1)
    ks = torch.fft.rfft(segs, n=2 * C, dim=-1)             # (nb, d, F)
    f = C + 1
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return {
        "ring": zeros(batch, C, d),
        "tail": zeros(batch, C, d),
        "uspec_re": zeros(batch, nb, f, d),
        "uspec_im": zeros(batch, nb, f, d),
        "khead": khead.contiguous(),
        "khs_re": khs.real.T.contiguous(),                 # (F, d)
        "khs_im": khs.imag.T.contiguous(),
        "kseg_re": ks.real.transpose(1, 2).contiguous(),   # (nb, F, d)
        "kseg_im": ks.imag.transpose(1, 2).contiguous(),
        "cap": zeros(max_len, 0),
    }


def _tail_from_specs(usr, usi, ksr_all, ksi_all, j):
    """Tail contributions for the block after block j retires: sum the
    cached block spectra against the kernel segment of their age (block j'
    has age m = j+1-j' → segment index j-j'), one irfft.

    ``j`` — an int block index (every row) or a (b,) tensor of per-row
    indices; both give the same bits per row."""
    nb, f = usr.shape[1], usr.shape[2]
    c = f - 1
    m_idx = (torch.as_tensor(j, device=usr.device)[..., None]
             - torch.arange(nb, device=usr.device))        # (nb,) | (b, nb)
    seg = m_idx.clamp(0, nb - 1)
    ksr, ksi = ksr_all[seg], ksi_all[seg]                  # (…, nb, F, d)
    # blocks not yet retired (j' > j) hold zero spectra; the mask also
    # guards the clamped (wrong-age) segment lookup for them
    valid = (m_idx >= 0).float()[..., None, None]
    accr = torch.sum(valid * (usr * ksr - usi * ksi), dim=1)
    acci = torch.sum(valid * (usr * ksi + usi * ksr), dim=1)
    full = torch.fft.irfft(torch.complex(accr, acci), n=2 * c, dim=1)
    return full[:, c - 1:2 * c - 1, :]


def stream_step(cache: dict, u: torch.Tensor, t) -> tuple[torch.Tensor, dict]:
    """One decode step: u (b, d) is the mixer input at position ``t``: an
    int (every row) or per-row host positions (see :func:`positions`).
    Returns (y (b, d) fp32, new cache).

    y_t = tail[t mod C] + Σ_{q=0..t mod C} khead[q]·u_{t-q}; a row whose
    step completes a block retires it and refreshes its tail. The refresh
    runs when the host positions put any row at a boundary, and the other
    rows keep ``tail``, ``uspec_re`` and ``uspec_im`` bit for bit."""
    ring, tail = cache["ring"], cache["tail"]
    b, c, d = ring.shape
    nb = cache["uspec_re"].shape[1]
    pos = positions(t, b, ring.device)
    p = pos.dev % c                                        # (b,) ring slot
    idx = torch.arange(c, device=ring.device)
    sel = idx[None, :] == p[:, None]                       # (b, C)
    ring = torch.where(sel[..., None], u.to(ring.dtype)[:, None, :], ring)
    # direct head: ring slot i holds position T+i → lag p-i, masked to the
    # tokens of the current block seen so far
    tau = p[:, None] - idx[None, :]                        # (b, C)
    kmat = torch.where((tau >= 0)[..., None],
                       cache["khead"].T[tau.clamp(0, c - 1)], 0.0)  # (b,C,d)
    rows = torch.arange(b, device=ring.device)
    y = (ring.float() * kmat).sum(dim=1) + tail[rows, p]

    usr, usi = cache["uspec_re"], cache["uspec_im"]
    if ((pos.host + 1) % c == 0).any():
        boundary = (pos.dev + 1) % c == 0                  # (b,)
        j = pos.dev // c                                   # (b,) block index
        u_spec = torch.fft.rfft(ring.float(), n=2 * c, dim=1)   # (b, F, d)
        # write each boundary row's block spectrum at that row's index j
        wsel = ((torch.arange(nb, device=ring.device)[None, :]
                 == j.clamp(0, nb - 1)[:, None])
                & boundary[:, None])[..., None, None]      # (b, nb, 1, 1)
        usr = torch.where(wsel, u_spec.real[:, None], usr)
        usi = torch.where(wsel, u_spec.imag[:, None], usi)
        fresh = _tail_from_specs(usr, usi, cache["kseg_re"],
                                 cache["kseg_im"], j)
        tail = torch.where(boundary[:, None, None], fresh, tail)
    new = dict(cache, ring=ring, tail=tail, uspec_re=usr, uspec_im=usi)
    return y, new


def stream_push_block(cache: dict, u_block: torch.Tensor,
                      t0: int) -> tuple[torch.Tensor, dict]:
    """Chunked prefill: feed a FULL block of C tokens at positions
    [t0, t0+C), t0 ≡ 0 (mod C). Returns (y (b, C, d) fp32, new cache).
    The intra-block causal conv runs through the head spectrum, reusing
    the rfft that retires the block — equivalent to C :func:`stream_step`
    calls, at FFT speed."""
    b, c, d = cache["ring"].shape
    uf = u_block.float()
    u_spec = torch.fft.rfft(uf, n=2 * c, dim=1)            # (b, F, d)
    ur, ui = u_spec.real, u_spec.imag
    khr, khi = cache["khs_re"][None], cache["khs_im"][None]
    yr = ur * khr - ui * khi
    yi = ur * khi + ui * khr
    y = (torch.fft.irfft(torch.complex(yr, yi), n=2 * c, dim=1)[:, :c]
         + cache["tail"])
    j = t0 // c
    usr, usi = cache["uspec_re"].clone(), cache["uspec_im"].clone()
    usr[:, j], usi[:, j] = ur, ui
    tail = _tail_from_specs(usr, usi, cache["kseg_re"], cache["kseg_im"], j)
    new = dict(cache, ring=uf, tail=tail, uspec_re=usr, uspec_im=usi)
    return y, new
