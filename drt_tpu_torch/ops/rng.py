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


def _key_word(seed, pix):
    """The word of (seed, pixel) that every draw of a pixel starts from."""
    return _fmix((_mul32(pix, GOLD) + seed) & MASK32)


def _draw_bits(word, b, dim: int):
    """32 keyed bits of draw (bounce b, dim) from the word of its (seed,
    pixel, sample): `_key_word(seed, pix) ^ _mul32(sample, C1)`."""
    return _fmix(word ^ (_mul32(b, C2) ^ ((dim * DIMSALT) & MASK32)))


def _uniform(bits, dtype):
    """The open-interval uniform (i23 + 0.5) * 2^-23 of the top 23 bits:
    a draw of exactly 0 or 1 would zero a sampling pdf
    (drt_tpu/ops/megakernel.py:817-837)."""
    return ((bits >> 9).to(dtype) + 0.5) * (1.0 / (1 << 23))


def hash_bits(seed, pix, s, b, dim: int, device=None) -> torch.Tensor:
    """32 keyed bits for draw (seed, pixel, sample, bounce, dim)."""
    seed, pix, s, b = (_u32(v, device) for v in (seed, pix, s, b))
    return _draw_bits(_key_word(seed, pix) ^ _mul32(s, C1), b, dim)


def hash_uniform(seed, pix, s, b, dim: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """The uniform of `hash_bits` (`_uniform`)."""
    return _uniform(torch.as_tensor(hash_bits(seed, pix, s, b, dim, device),
                                    device=device), dtype)


def camera_draws(seed, pix, s, dtype=torch.float32) -> torch.Tensor:
    """The camera's two draws f[2, N] of rays (pix, s): dims 0 and 1 of
    bounce 0 of `seed` (the camera seed, seeds[0])."""
    return torch.stack([hash_uniform(seed, pix, s, 0, dim, dtype, pix.device)
                        for dim in (0, 1)])


def bounce_tape(seed, pix, s, depth: int, dtype=torch.float32,
                first: int = 0) -> torch.Tensor:
    """The bounce draws f[depth - first, 3, N] of rays (pix, s) at the
    bounces first..depth-1, slots (rr, u1, u2) per bounce, from `seed`
    (the bounce seed, seeds[1]): `prefix_tape` of one lane a ray."""
    return prefix_tape(seed, pix, s, 1, depth, dtype, first=first)


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


def split_lanes(n_split: int, depth: int) -> int:
    """Leaf lanes M = n_split^(depth - 1) of one camera sample under
    per-vertex splitting: bounces 0..depth-2 each branch n_split ways (the
    last bounce's sampled direction is never traced)."""
    return n_split ** max(depth - 1, 0)


def prefix_tape(seed, pix: torch.Tensor, s: torch.Tensor, n_split: int,
                depth: int, dtype=torch.float32, lanes_outer: bool = False,
                n_samples: int | None = None, first: int = 0,
                lanes: tuple | None = None) -> torch.Tensor:
    """The prefix-shared bounce draws f[depth - first, 3, N * M] of the
    rays (pix, s) (i64[N] each) at the bounces first..depth-1, each ray
    split into M = `split_lanes(n_split, depth)` leaf lanes, from `seed`
    (the bounce seed, seeds[1]).

    Lane m holds the branch digits (j_1 .. j_{depth-1}), j_1 the most
    significant (drt_tpu/renderer.py:_trace_rays_splitting). The vertex
    of bounce b is fixed by the first b digits, so its roulette draw is
    shared by the n^(depth-1-b) lanes of prefix m // n^(depth-1-b), and
    the (u1, u2) draw that makes child j_{b+1} by the n^(depth-2-b) lanes
    of prefix m // n^(depth-2-b) (one lane at the last bounce). A group
    whose lowest lane is m0 draws slot k of bounce b as
    `hash_uniform(seed, pix, s * M + m0, b, k)`: at M = 1 these are the
    draws of `bounce_tape`, and no two groups of one sample share a draw.

    Lanes are ray-major (lane r * M + m, the wavefront's order) or, with
    lanes_outer, M-outer (lane m * N + r, the fused kernels' order, whose
    pixel is lane % (W*H)). The samples must lie below n_samples (by
    default read from s) with n_samples * M <= 2^31: the kernels carry
    sample indices in 31 bits. lanes=(start, stop), M-outer only, draws
    those lanes alone (a shard's), f[depth - first, 3, stop - start], bit
    for bit that slice of the whole: the leaves m = start // N ..
    (stop - 1) // N it crosses are drawn (over the range's own rays where
    it lies in one leaf) and the range cut from them.

    The draws are made group by group: the word of (seed, pix) once, the
    word of each group's sample index once for every bounce and slot that
    shares its size, then expanded into the lanes in place.
    """
    M = split_lanes(n_split, depth)
    n = pix.shape[0]
    dev = pix.device
    if M > 1:
        if n_samples is None:
            n_samples = int(s.max()) + 1 if n else 0
        if n_samples * M > 2 ** 31:
            raise ValueError(f"sample index exceeds 31 bits: {n_samples} "
                             f"samples x {M} split lanes")
    m_lo, m_hi, cut = 0, M, None  # the leaves drawn; the lanes kept
    if lanes is not None:
        if not lanes_outer:
            raise ValueError("a lane range is of the M-outer order")
        start, stop = lanes
        m_lo, m_hi = start // n, -(-stop // n)
        if m_hi - m_lo == 1:
            pix, s = (t[start - m_lo * n:stop - m_lo * n] for t in (pix, s))
            n = stop - start
        else:
            cut = (start - m_lo * n, stop - m_lo * n)
    key = _key_word(_u32(seed, dev), _u32(pix, dev))
    base = _u32(s, dev) * M
    tape = torch.empty((depth - first, 3, n * (m_hi - m_lo)), dtype=dtype,
                       device=dev)
    words = {}  # lanes per group -> the group's word, [G, N] or [N, G]
    for b in range(first, depth):
        rr_size = M // min(n_split ** b, M)
        u_size = M // min(n_split ** (b + 1), M)
        for size in [k for k in words if k > rr_size]:
            del words[size]  # the groups only shrink with the bounce
        for dim, size in ((0, rr_size), (1, u_size), (2, u_size)):
            if size not in words:
                m0 = torch.arange(m_lo // size, -(-m_hi // size),
                                  dtype=torch.int64, device=dev) * size
                idx = (base[None, :] + m0[:, None] if lanes_outer
                       else base[:, None] + m0[None, :])
                kk = key[None, :] if lanes_outer else key[:, None]
                words[size] = kk ^ _mul32(idx, C1)
            u = _uniform(_draw_bits(words[size], b, dim), dtype)
            if lanes_outer:
                _spread(tape[b - first, dim].view(m_hi - m_lo, n), u, m_lo,
                        m_hi, size)
            else:
                tape[b - first, dim].view(n, M // size, size).copy_(
                    u[:, :, None])
    if cut is not None:
        tape = tape[..., cut[0]:cut[1]].contiguous()
    return tape


def _spread(out: torch.Tensor, u: torch.Tensor, m_lo: int, m_hi: int,
            size: int) -> None:
    """out[L, N] holds the leaves m_lo..m_hi - 1 of an M-outer tape; leaf m
    takes the draws u[m // size - m_lo // size] of its group (u[G, N], the
    groups the leaves fall in): a group cut by the range's first or last
    leaf is one broadcast copy, the whole groups between one more."""
    g_lo = m_lo // size
    a = min(-(-m_lo // size) * size, m_hi)  # the first group edge
    z = max(m_hi // size * size, a)  # the last
    if a > m_lo:
        out[:a - m_lo].copy_(u[0])
    if z > a:
        out[a - m_lo:z - m_lo].view((z - a) // size, size, out.shape[1]) \
            .copy_(u[a // size - g_lo:z // size - g_lo, None, :])
    if m_hi > z:
        out[z - m_lo:].copy_(u[z // size - g_lo])
