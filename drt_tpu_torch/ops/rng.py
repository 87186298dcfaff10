"""Keyed counter-based uniforms: the hash of `drt_tpu.ops.regen`
(`_fmix`, `_hash_bits`, `hash_uniform`, `hash_tapes`), bit for bit.

Each draw is a pure function of (seed, pixel, sample, bounce, dim), so a
CUDA thread can draw its own samples in any order and the tapes built here
reproduce them exactly. The port's fused tracer draws from it in place of
the TPU's per-core PRNG (`pltpu.prng_random_bits`), which has no GPU
counterpart.

Torch has no full uint32 arithmetic, so words are carried in int64 and
cut to 32 bits after every step; a product is split in 16-bit halves so
that no intermediate leaves the int64 range.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# murmur3 fmix32 constants + Weyl/dim salts (drt_tpu/ops/regen.py:69-72).
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLD = 0x9E3779B9
DIMSALT = 0x27D4EB2F


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 32-bit x and constant c, in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on 32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, C1)
    x = x ^ (x >> 13)
    x = _mul32(x, C2)
    return x ^ (x >> 16)


def _u32(v, device):
    """An i32 or u32 value as its 32-bit word: a tensor as int64 on
    `device`, a Python number as a Python int (moving a scalar to the card
    would wait for the card's queue)."""
    if torch.is_tensor(v):
        return v.to(device=device, dtype=torch.int64) & MASK32
    return int(v) & MASK32


def hash_bits(seed, pix, s, b, dim: int, device=None) -> torch.Tensor:
    """32 keyed bits for draw (seed, pixel, sample, bounce, dim)."""
    seed, pix, s, b = (_u32(v, device) for v in (seed, pix, s, b))
    h = _fmix((_mul32(pix, GOLD) + seed) & MASK32)
    return _fmix(h ^ _mul32(s, C1) ^ _mul32(b, C2)
                 ^ ((dim * DIMSALT) & MASK32))


def hash_uniform(seed, pix, s, b, dim: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """The open-interval uniform (i23 + 0.5) * 2^-23 of the top 23 hash
    bits: a draw of exactly 0 or 1 would zero a sampling pdf
    (drt_tpu/ops/megakernel.py:817-837)."""
    i23 = torch.as_tensor(hash_bits(seed, pix, s, b, dim, device) >> 9,
                          device=device)
    return (i23.to(dtype) + 0.5) * (1.0 / (1 << 23))


def camera_draws(seed, pix, s, dtype=torch.float32) -> torch.Tensor:
    """The camera's two draws f[2, N] of rays (pix, s): dims 0 and 1 of
    bounce 0 of `seed` (the camera seed, seeds[0])."""
    return torch.stack([hash_uniform(seed, pix, s, 0, dim, dtype, pix.device)
                        for dim in (0, 1)])


def bounce_tape(seed, pix, s, depth: int, dtype=torch.float32,
                first: int = 0) -> torch.Tensor:
    """The bounce draws f[depth - first, 3, N] of rays (pix, s) at the
    bounces first..depth-1, slots (rr, u1, u2) per bounce, from `seed`
    (the bounce seed, seeds[1])."""
    return torch.stack([
        torch.stack([hash_uniform(seed, pix, s, b, dim, dtype, pix.device)
                     for dim in (0, 1, 2)])
        for b in range(first, depth)])


def hash_tapes(seeds, npix: int, spp: int, depth: int, dtype=torch.float32,
               sample_base: int = 0, device=None):
    """The draws in spp-outer ray order (ray i -> pixel i % npix, sample
    sample_base + i // npix): (cam_u f[2, N], tape f[depth, 3, N]) with
    N = npix * spp. Camera dims come from seeds[0] at bounce 0, bounce
    dims (rr, u1, u2) from seeds[1]."""
    seeds = [int(v) for v in seeds]
    i = torch.arange(npix * spp, dtype=torch.int64, device=device)
    pix = i % npix
    s = i // npix + sample_base
    return (camera_draws(seeds[0], pix, s, dtype),
            bounce_tape(seeds[1], pix, s, depth, dtype))
