"""The fused tracer and its adjoints: the CUDA kernels and their plain
PyTorch twins.

The ports of `drt_tpu.ops.megakernel`'s full-depth fused kernels, with
N = W*H*spp/spp_chunks ray slots, D = max_depth, C = n_chunks:
  `make_fused_tracer` (Pallas `make_fused_segment_tracer`): camera ray
    generation, sampling and the whole bounce loop in one launch, radiance
    f32[3, N] out, summed over the spp chunks;
  `make_fused_collect_tracer`: the same trace, which also writes the
    residuals rsc f32[C, D, N] (the sampling weight sc) and rbest
    i32[C, D, N] (hit shape + 1, 0 for a dead lane); [D, N] when C == 1;
  `make_fused_sweep_adjoint`: (d_albedo f32[K+1, 3], d_emission f32[L+1,
    3]) from those residuals and a cotangent g, by replaying the
    throughput and a reverse sweep, no geometry;
  `make_fused_adjoint` (Pallas `make_fused_segment_adjoint`): the same
    gradients by retracing the forward in the kernel;
  `make_pallas_tracer` (Pallas `make_pallas_tracer`): the bounce loop on
    primary rays and a tape given as inputs, no camera and no RNG inside,
    radiance f32[3, N] out: `renderer.trace_rays(tape=u)` as one kernel,
    the forward of the key-driven wavefront (`adjoint.py`);
  `make_pallas_adjoint` (Pallas `make_pallas_adjoint`): its backward,
    `trace_rays(collect=True)` + `adjoint._param_grads` as one kernel.
The kernels are `csrc/fused_tracer.cu` (tracer, collect tracer, wavefront
tracer) and `csrc/fused_adjoint.cu` (sweep, retrace and wavefront adjoints)
over the shared bounce body `csrc/fused_body.cuh`; the source notes say
what bounds each and how the designs differ from the TPU kernels'.

Where the TPU kernel bakes the scene in as literals, the port builds a
small table from the scene arrays (`scene_table`, precomputed in f64 on
the host as `StaticScene` does) and the kernel reads it at run time.
The camera basis is folded on the host the same way (`camera_consts`,
including the `aspect*half` literal that differs in its last ulp from
`camera.camera_rays`).

Uniforms, in spp-outer ray order (ray i is pixel i % (W*H)):
  rng="internal": the keyed hash of `ops.rng`, drawn in the kernel; for
    chunk c these are `hash_tapes(seeds, W*H, spp_c, D, sample_base=c*spp_c)`;
  rng="tape": cam_u f32[2, N] and tape f32[D, 3, N] given by the caller.

The cotangent g is f[3, N] per ray slot (identical across chunks), or
f[3, W*H] per pixel, which the kernels index by pixel themselves.

A shard of a device mesh launches on n_rays slots from `ray_base` (the
`DrtTrace` field, by default 0): its slot i is the image's slot ray_base
+ i, whose pixel and sample the camera ray and the keyed draws take; a
tape, the cotangent (per ray) and the outputs hold the shard's slots
alone. The sweeps read residuals and draw nothing: they take no offset.

`fused_trace`, `fused_collect`, `fused_sweep`, `fused_adjoint`, `ray_trace`
and `ray_adjoint` are the wrappers: for tensors on the CPU each runs its
plain twin (the fused camera math, `renderer.trace_residuals`, and the
replay and sweep in the kernels' op order, fed the same uniforms); for
CUDA tensors it launches its kernel or raises. Each counts its launches in `<wrapper>.launches`;
`launch_counts()` reads them all, with those of the memory-resident
kernels (`ops.dynkernel`, which registers its wrappers here), and
`reset_launch_counts()` zeroes them.

The tracer, the collect tracer, the retrace adjoint and the wavefront
adjoint run a queue of (ray slot, chunk) paths that spends a trip only on
a live bounce; `build="lockstep"` launches their checking builds of the
lockstep loop (every bounce of every slot), the bit reference, and
`fused_trace_stats` / `fused_adjoint_stats` the checking builds that count
and time either loop. The segment tracer and the segment adjoint run a
queue of their lanes, each one path, where lanes can enter dead
(b_start > 0), and the lockstep loop from the camera
(`segment_trace_form`, `segment_form`); `build="lockstep"` launches the
lockstep loop at every call, the queue's bit reference.
None of these is counted as a launch. `trip_counts_plain` gives the
lane-trips each slot takes in the queue, from a collect tracer's rows
and the roulette draws.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.rng import (bounce_tape, camera_draws, hash_tapes,
                                   hash_uniform)
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.renderer import trace_residuals, trace_rays, trace_segment
from drt_tpu_torch.scene import Params, Scene, SPHERE, TRIANGLE

SOURCE = "fused_tracer.cu"
ADJOINT_SOURCE = "fused_adjoint.cu"
# Bounds of the kernels' shared-memory tables (DRT_* in the sources), the
# deepest path the adjoint kernels keep per thread (beyond it their deep
# forms keep the rest in device memory, csrc/grad_accum.cuh), and their
# block size.
MAX_SHAPES = 64
MAX_ROWS = 64
REC = 32
MAX_DEPTH = 32
BLOCK = 128
# Shape record layout (R_* in the source).
R_TYPE, R_MAT, R_ALB, R_EMI, R_GEO = 0, 1, 2, 3, 4
R_E1, R_E2, R_TRI_N, R_R2 = 16, 19, 22, 25
R_EXPO, R_INV_E2, R_POW_MODE = 26, 27, 28
POW_NONINT, POW_EVEN, POW_ODD = 0, 1, 2
# The checking build drt_fused_trace_stats (FS_* and SEC_* in the
# sources): step counts, then cycles per section, then the live lanes per
# warp-bounce by bounce ([max_depth, 33], the lockstep loop only).
STEP_STATS = ("lane_steps", "warp_steps", "live_lanes", "live_warps")
SECTIONS = ("camera", "draws", "hit", "shade", "hook", "tail", "loop")
N_SECT = len(SECTIONS)
# The retrace adjoint's timing build drt_fused_adjoint_stats (AS_* in
# fused_adjoint.cu): the step counts, then cycles per section, the
# bounce's and the adjoint's own.
ADJOINT_SECTIONS = SECTIONS + ("sweep", "reduce")
# The loops of the tracer, the collect tracer, the two retrace adjoints and
# the segment adjoint: "queue" (the wrappers' kernels) and "lockstep" (a
# checking build, the bit reference).
BUILDS = ("queue", "lockstep")


def scene_table(scene: Scene) -> torch.Tensor:
    """The scene as f32[S, REC] shape records on the scene's device.

    Per shape: type, material type, albedo row, emission row, geo[12],
    and what the TPU kernel folds at build time in f64 (StaticScene,
    megakernel.py:191-193, :277-279): triangle edges and unit normal,
    sphere r^2, the specular exponent, 1/(e+2) and its pow sign mode.
    """
    st = scene.shape_type.tolist()
    if len(st) > MAX_SHAPES:
        raise ValueError(f"{len(st)} shapes exceed the fused tracer's "
                         f"table of {MAX_SHAPES}; larger scenes take the "
                         "memory-resident kernels (backend 'cuda-dyn')")
    geo = scene.shape_geo.detach().double().cpu().numpy()
    shape_mat = scene.shape_mat.tolist()
    shape_emit = scene.shape_emit.tolist()
    mat_type = scene.mat_type.tolist()
    mat_albedo = scene.mat_albedo.tolist()
    mat_exp = scene.mat_exponent.detach().double().cpu().numpy()
    tab = np.zeros((len(st), REC), np.float64)
    for s, stype in enumerate(st):
        m = shape_mat[s]
        g = geo[s]
        tab[s, [R_TYPE, R_MAT, R_ALB, R_EMI]] = (
            stype, mat_type[m], mat_albedo[m], shape_emit[s])
        tab[s, R_GEO:R_GEO + 12] = g
        if stype == TRIANGLE:
            e1 = g[3:6] - g[0:3]
            e2 = g[6:9] - g[0:3]
            n = np.cross(e1, e2)
            tab[s, R_E1:R_E1 + 3] = e1
            tab[s, R_E2:R_E2 + 3] = e2
            tab[s, R_TRI_N:R_TRI_N + 3] = n / np.linalg.norm(n)
        elif stype == SPHERE:
            tab[s, R_R2] = g[3] * g[3]
        expo = float(mat_exp[m])
        tab[s, R_EXPO] = expo
        tab[s, R_INV_E2] = 1.0 / (expo + 2.0)
        tab[s, R_POW_MODE] = (POW_NONINT if expo != int(expo) else
                              POW_ODD if int(expo) % 2 == 1 else POW_EVEN)
    return torch.as_tensor(tab.astype(np.float32), device=scene.device)


class CameraConsts(NamedTuple):
    """The camera folded for the fused tracer (StaticCamera): f32 values
    as Python floats, and the image size."""

    eye: tuple
    forward: tuple
    right: tuple
    up: tuple
    aspect_half: float  # f32(aspect * tan(vfov/2)), folded in f64
    half: float
    width: int
    height: int


def camera_consts(cam, width: int, height: int) -> CameraConsts:
    def f32s(t):
        return tuple(float(np.float32(v)) for v in t.detach().cpu().tolist())

    half = float(np.tan(float(cam.vfov) / 2.0))
    aspect = float(width) / float(height)
    return CameraConsts(f32s(cam.eye), f32s(cam.forward), f32s(cam.right),
                        f32s(cam.up), float(np.float32(aspect * half)),
                        float(np.float32(half)), width, height)


def camera_ray_from_pix(cc: CameraConsts, pix: torch.Tensor,
                        u_s: torch.Tensor, u_t: torch.Tensor):
    """Primary rays for pixel indices, in the op order of the TPU
    kernel's `_camera_ray_from_pix` (camera.hpp:51-60): d =
    normalize((forward + right*a) + (-up)*b). Returns (o, d) V3s."""
    dtype = u_s.dtype
    y = pix // cc.width
    x = pix - y * cc.width
    s = (x.to(dtype) + u_s) / cc.width
    t = (y.to(dtype) + u_t) / cc.height
    a = (2.0 * s - 1.0) * cc.aspect_half
    b = (2.0 * t - 1.0) * cc.half
    dx, dy, dz = ((cc.forward[k] + a * cc.right[k]) + b * (-cc.up[k])
                  for k in range(3))
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    o = V3(*(torch.full_like(u_s, e) for e in cc.eye))
    return o, V3(dx * inv, dy * inv, dz * inv)


def ray_ids(cfg: RenderConfig, n: int, ray_base: int = 0, device=None):
    """(pixel i64[n], sample in the chunk i64[n]) of the ray slots
    [ray_base, ray_base + n) of one chunk, spp-outer: the global slot g
    covers pixel g % (W*H) and sample g // (W*H)."""
    npix = cfg.width * cfg.height
    g = torch.arange(ray_base, ray_base + n, dtype=torch.int64,
                     device=device)
    return g % npix, g // npix


def _chunk_uniforms(cfg: RenderConfig, alb, seeds, cam_u, tape, c: int,
                    pix=None, s=None):
    """Chunk c's (cam_u, tape): the keyed draws of the internal RNG at the
    rays (pix, s) (`ray_ids`; by default every slot of the chunk), the
    hash tapes of the chunk, or the caller's."""
    if seeds is None:
        return cam_u, tape
    if pix is None:
        pix, s = ray_ids(cfg, cfg.width * cfg.height
                         * (cfg.spp // cfg.spp_chunks), device=alb.device)
    s0, s1 = _seed_words(seeds, 0)
    smp = c * (cfg.spp // cfg.spp_chunks) + s
    return (camera_draws(s0, pix, smp, alb.dtype),
            bounce_tape(s1, pix, smp, cfg.max_depth, alb.dtype))


def _slots(cfg: RenderConfig, n_rays, ray_base: int, device):
    """The n slots of a launch, n_rays of them from ray_base on (by
    default the chunk's), as (n, pixel, sample in the chunk)."""
    npix = cfg.width * cfg.height
    n = npix * (cfg.spp // cfg.spp_chunks) if n_rays is None else n_rays
    return (n, *ray_ids(cfg, n, ray_base, device))


def fused_trace_plain(scene: Scene, cc: CameraConsts, cfg: RenderConfig,
                      alb: torch.Tensor, emi: torch.Tensor, *, seeds=None,
                      cam_u=None, tape=None, n_chunks: int = 1,
                      ray_base: int = 0, n_rays: int | None = None
                      ) -> torch.Tensor:
    """The plain PyTorch twin of the tracer, on the tensors' device.
    Pass `seeds` (internal RNG, any n_chunks) or `cam_u` and `tape`.
    Returns radiance f[3, N] summed over the chunks, N = n_rays slots
    from ray_base on (by default one chunk's W*H*spp_c from 0)."""
    _, pix, smp = _slots(cfg, n_rays, ray_base, alb.device)
    params = Params(albedo=alb[:-1], emission=emi[:-1])
    L = None
    for c in range(n_chunks):
        cu, tp = _chunk_uniforms(cfg, alb, seeds, cam_u, tape, c, pix, smp)
        o, d = camera_ray_from_pix(cc, pix, cu[0], cu[1])
        Lc = torch.stack(trace_rays(params, scene, o, d, cfg, tape=tp))
        L = Lc if L is None else L + Lc
    return L


def fused_collect_plain(scene: Scene, cc: CameraConsts, cfg: RenderConfig,
                        alb: torch.Tensor, emi: torch.Tensor, *, seeds=None,
                        cam_u=None, tape=None, n_chunks: int = 1,
                        ray_base: int = 0, n_rays: int | None = None):
    """The plain twin of the collect tracer: (radiance f[3, N] summed over
    the chunks, rsc f[C, D, N], rbest i32[C, D, N]), the chunk dimension
    dropped when n_chunks == 1; the slots as `fused_trace_plain`'s."""
    _, pix, smp = _slots(cfg, n_rays, ray_base, alb.device)
    params = Params(albedo=alb[:-1], emission=emi[:-1])
    L = None
    rsc, rbest = [], []
    for c in range(n_chunks):
        cu, tp = _chunk_uniforms(cfg, alb, seeds, cam_u, tape, c, pix, smp)
        o, d = camera_ray_from_pix(cc, pix, cu[0], cu[1])
        Lc, res, shape = trace_residuals(params, scene, o, d, cfg, tp)
        Lc = torch.stack(Lc)
        L = Lc if L is None else L + Lc
        rsc.append(res.sc)
        rbest.append(torch.where(res.gate > 0, shape + 1, 0)
                     .to(torch.int32))
    if n_chunks == 1:
        return L, rsc[0], rbest[0]
    return L, torch.stack(rsc), torch.stack(rbest)


def _per_ray(g: torch.Tensor, n: int) -> torch.Tensor:
    """Cotangent f[3, N], or f[3, W*H] tiled over the spp-outer slots."""
    if g.shape[1] == n:
        return g
    return g.repeat(1, n // g.shape[1])


def sweep_rows_plain(cfg: RenderConfig, alb: torch.Tensor,
                     emi: torch.Tensor, rsc: torch.Tensor, rows_of,
                     g: torch.Tensor):
    """Replay and reverse sweep over residuals rsc f[C, D, n], shared by
    the sweep twins of both kernel families: `rows_of(c, b)` gives (live
    bool[n], albedo row i64[n], emission row i64[n]) of a bounce, the
    sentinel rows on a dead lane. Replays `gate = rr [live]`, `P = T
    gate`, `T = (P a) sc` in the kernels' op order, then the reverse sweep
    of `adjoint._param_grads`. Returns (d_albedo f[K+1, 3], d_emission
    f[L+1, 3]), sentinel rows zero."""
    n_chunks, D, n = rsc.shape
    dtype, dev = alb.dtype, alb.device
    n_alb, n_emi = alb.shape[0], emi.shape[0]
    g = _per_ray(g, n)
    inv_keep = 1.0 / (1.0 - cfg.absorb_prob)
    da = torch.zeros((n_alb, 3), dtype=dtype, device=dev)
    de = torch.zeros((n_emi, 3), dtype=dtype, device=dev)

    def add_rows(acc, rows, v, n_rows):
        for k in range(n_rows - 1):  # the sentinel row stays zero
            acc[k] += torch.where(rows == k, v, 0.0).sum(dim=1)

    for c in range(n_chunks):
        T = torch.ones((3, n), dtype=dtype, device=dev)
        steps = []
        for b in range(D):
            live, arow, erow = rows_of(c, b)
            sc = rsc[c, b]
            rr = inv_keep if b >= cfg.min_bounces else 1.0
            gate = live.to(dtype) * rr  # rr rounded to dtype once
            P = T * gate
            a = alb[arow].T
            T = P * a * sc
            steps.append((P, sc, gate, arow, erow, a))
        S = torch.zeros((3, n), dtype=dtype, device=dev)
        for P, sc, gate, arow, erow, a in reversed(steps):
            gP = g * P
            add_rows(de, erow, gP, n_emi)
            add_rows(da, arow, gP * sc * S, n_alb)
            S = (emi[erow].T + a * sc * S) * gate
    return da, de


def fused_sweep_plain(scene: Scene, cfg: RenderConfig, alb: torch.Tensor,
                      emi: torch.Tensor, rsc: torch.Tensor,
                      rbest: torch.Tensor, g: torch.Tensor):
    """The plain twin of the sweep adjoint: `sweep_rows_plain` with the
    rows of each bounce looked up from `rbest` (hit shape + 1, 0 for a
    dead lane)."""
    if rsc.ndim == 2:
        rsc, rbest = rsc[None], rbest[None]
    dev = alb.device
    # Row of each table by best (0 = dead lane -> the sentinel rows).
    arow_of = torch.tensor(
        [alb.shape[0] - 1]
        + scene.mat_albedo[scene.shape_mat.long()].tolist(), device=dev)
    erow_of = torch.tensor([emi.shape[0] - 1] + scene.shape_emit.tolist(),
                           device=dev)

    def rows_of(c, b):
        best = rbest[c, b].long()
        return best > 0, arow_of[best], erow_of[best]

    return sweep_rows_plain(cfg, alb, emi, rsc, rows_of, g)


def fused_adjoint_plain(scene: Scene, cc: CameraConsts, cfg: RenderConfig,
                        alb: torch.Tensor, emi: torch.Tensor,
                        g: torch.Tensor, *, seeds=None, cam_u=None,
                        tape=None, n_chunks: int = 1, ray_base: int = 0,
                        n_rays: int | None = None):
    """The plain twin of the retrace adjoint: the collect twin, then the
    sweep twin on its residuals."""
    _, rsc, rbest = fused_collect_plain(scene, cc, cfg, alb, emi,
                                        seeds=seeds, cam_u=cam_u, tape=tape,
                                        n_chunks=n_chunks, ray_base=ray_base,
                                        n_rays=n_rays)
    return fused_sweep_plain(scene, cfg, alb, emi, rsc, rbest, g)


class _DrtCamera(ctypes.Structure):
    _fields_ = [("eye", ctypes.c_float * 3), ("fwd", ctypes.c_float * 3),
                ("right", ctypes.c_float * 3), ("up", ctypes.c_float * 3),
                ("aspect_half", ctypes.c_float), ("half", ctypes.c_float)]


class _DrtTrace(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "width", "height", "n_rays", "spp_c", "n_chunks", "max_depth",
        "min_bounces", "n_shapes", "n_alb", "n_emi", "internal_rng",
        "fast")] + [("absorb", ctypes.c_float), ("inv_keep", ctypes.c_float),
                    ("seed0", ctypes.c_uint32), ("seed1", ctypes.c_uint32),
                    ("ray_base", ctypes.c_int)]


def _bind(lib, name: str, n_pointers: int, structs=(), n_ints_at=()) -> None:
    """argtypes of an entry point: `structs` first, then `n_pointers`
    void pointers with a C int at the positions `n_ints_at` among them."""
    vp = ctypes.c_void_p
    args = [ctypes.POINTER(t) for t in structs]
    args += [ctypes.c_int if k in n_ints_at else vp
             for k in range(n_pointers)]
    fn = getattr(lib, name)
    fn.argtypes = args
    fn.restype = ctypes.c_int


def _bind_stages(lib, name: str) -> None:
    """argtypes of a sweep's stage query: n_alb, n_emi, max_depth, and
    the int it writes."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


def _stages(fn, what: str, n_alb: int, n_emi: int, max_depth: int) -> int:
    got = ctypes.c_int()
    rc = fn(n_alb, n_emi, max_depth, ctypes.byref(got))
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")
    return got.value


def _bind_deep_bytes(lib) -> None:
    """argtypes of an adjoint library's drt_deep_bytes: n, depth, n_alb,
    n_emi and the u64 it writes."""
    fn = lib.drt_deep_bytes
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_ulonglong)]
    fn.restype = ctypes.c_int


def deep_scratch(lib, n: int, depth: int, n_alb: int, n_emi: int,
                 dev) -> torch.Tensor | None:
    """The device-memory scratch of an adjoint kernel's deep form over n
    items (ray slots, pixels or lanes) of `depth` rows a path, as large as
    the library's drt_deep_bytes says; None where it says 0: the launch
    takes the in-thread form (up to DEEP_WINDOW rows and DEEP_MAX_ACC_ROWS
    real table rows, csrc/grad_accum.cuh)."""
    got = ctypes.c_ulonglong()
    with torch.cuda.device(dev):
        rc = lib.drt_deep_bytes(n, depth, n_alb, n_emi, ctypes.byref(got))
    if rc:
        raise RuntimeError(f"deep scratch size: CUDA error {rc}")
    if not got.value:
        return None
    return torch.empty(got.value, dtype=torch.uint8, device=dev)


def _check_limits(source: str, fn, expected: list) -> None:
    got = [ctypes.c_int() for _ in expected]
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(expected)
    fn.restype = ctypes.c_int
    fn(*(ctypes.byref(v) for v in got))
    if [v.value for v in got] != expected:
        raise RuntimeError(f"{source} bounds {[v.value for v in got]} "
                           f"differ from the wrapper's {expected}")


def _library() -> ctypes.CDLL:
    """The tracer library: drt_fused_trace, drt_fused_collect,
    drt_ray_trace, drt_ray_trace_keyed, drt_fused_segment_trace (and its
    choice of loop, drt_fused_segment_trace_form), drt_earlyexit_trace
    and the checking builds drt_fused_trace_lockstep,
    drt_fused_collect_lockstep, drt_ray_trace_lockstep,
    drt_fused_segment_trace_lockstep, drt_fused_trace_stats."""
    from drt_tpu_torch.utils import native

    lib = native.load(SOURCE)
    if lib.drt_fused_trace.argtypes is None:
        both = (_DrtTrace, _DrtCamera)
        # scene, alb, emi, cam_u, tape, out, [sums, rsc, rbest,] stream
        _bind(lib, "drt_fused_trace", 7, both)
        _bind(lib, "drt_fused_collect", 10, both)
        # scene, alb, emi, cam_u, tape, out, [rsc, rbest,] stream
        _bind(lib, "drt_fused_trace_lockstep", 7, both)
        _bind(lib, "drt_fused_collect_lockstep", 9, both)
        # scene, alb, emi, out, sums, rsc, rbest, trips, stats, queue,
        # stream
        _bind(lib, "drt_fused_trace_stats", 11, both, n_ints_at=(9,))
        # scene, alb, emi, o, d, tape | pix, smp, out, stream
        _bind(lib, "drt_ray_trace", 8, (_DrtTrace,))
        _bind(lib, "drt_ray_trace_lockstep", 8, (_DrtTrace,))
        _bind(lib, "drt_ray_trace_keyed", 9, (_DrtTrace,))
        # b_start, b_end, chunk, scene, alb, emi, cam_u, tape, ray, alive,
        # ray_idx, out, ray_out, alive_out, stream
        _bind(lib, "drt_fused_segment_trace", 15, both, n_ints_at=(0, 1, 2))
        _bind(lib, "drt_fused_segment_trace_lockstep", 15, both,
              n_ints_at=(0, 1, 2))
        fn = lib.drt_fused_segment_trace_form
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        _bind(lib, "drt_earlyexit_trace", 7, both)
        lib.drt_error_string.argtypes = [ctypes.c_int]
        lib.drt_error_string.restype = ctypes.c_char_p
        _check_limits(SOURCE, lib.drt_limits,
                      [MAX_SHAPES, MAX_ROWS, REC, len(STEP_STATS) + N_SECT])
    return lib


def _adjoint_library() -> ctypes.CDLL:
    """The adjoint library: drt_fused_sweep, drt_fused_adjoint,
    drt_ray_adjoint, drt_fused_segment_adjoint (and its choice of loop,
    drt_fused_segment_form), the checking builds
    drt_fused_adjoint_lockstep, drt_ray_adjoint_lockstep,
    drt_fused_segment_adjoint_lockstep and the timing build
    drt_fused_adjoint_stats."""
    from drt_tpu_torch.utils import native

    lib = native.load(ADJOINT_SOURCE)
    if lib.drt_fused_sweep.argtypes is None:
        # scene, alb, emi, rsc, rbest, g, g_n, scratch, partials, da, de,
        # stream
        _bind(lib, "drt_fused_sweep", 12, (_DrtTrace,), n_ints_at=(6,))
        _bind_stages(lib, "drt_fused_sweep_stages")
        _bind_deep_bytes(lib)
        # scene, alb, emi, cam_u, tape, g, g_n, [slot_acc, scratch,]
        # partials, da, de, stream
        _bind(lib, "drt_fused_adjoint", 13, (_DrtTrace, _DrtCamera),
              n_ints_at=(6,))
        _bind(lib, "drt_fused_adjoint_lockstep", 11,
              (_DrtTrace, _DrtCamera), n_ints_at=(6,))
        # scene, alb, emi, o, d, tape, g, [slot_acc, scratch,] partials,
        # da, de, stream
        _bind(lib, "drt_ray_adjoint", 13, (_DrtTrace,))
        _bind(lib, "drt_ray_adjoint_lockstep", 11, (_DrtTrace,))
        # b_start, b_end, chunk, scene, alb, emi, cam_u, tape, ray, alive,
        # ray_idx, g, g_n, s_end, scratch, partials, da, de, s_start, stream
        _bind(lib, "drt_fused_segment_adjoint_lockstep", 20,
              (_DrtTrace, _DrtCamera), n_ints_at=(0, 1, 2, 12))
        # ... s_end, next_group, scratch, partials, da, de, s_start, stream
        _bind(lib, "drt_fused_segment_adjoint", 21, (_DrtTrace, _DrtCamera),
              n_ints_at=(0, 1, 2, 12))
        fn = lib.drt_fused_segment_form
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        # scene, alb, emi, g, g_n, slot_acc, partials, da, de, stats,
        # queue, stream
        _bind(lib, "drt_fused_adjoint_stats", 12, (_DrtTrace, _DrtCamera),
              n_ints_at=(4, 10))
        lib.drt_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.drt_adjoint_error_string.restype = ctypes.c_char_p
        _check_limits(ADJOINT_SOURCE, lib.drt_adjoint_limits,
                      [MAX_SHAPES, MAX_ROWS, REC, MAX_DEPTH, BLOCK,
                       len(STEP_STATS) + len(ADJOINT_SECTIONS)])
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).split('.')[-1]} on "
                        f"the card, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(name: str, alb: torch.Tensor) -> str:
    if alb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not "
                         f"{alb.device.type}")
    return alb.device.type


def _seed_words(seeds, n_samples: int) -> list:
    """The (camera, bounce) seed pair as two u32 words; [0, 0] in tape
    mode."""
    if seeds is None:
        return [0, 0]
    words = [int(v) & 0xFFFFFFFF for v in
             (seeds.tolist() if torch.is_tensor(seeds) else seeds)]
    if len(words) != 2:
        raise ValueError("seeds must hold 2 words (camera, bounce)")
    if n_samples >= 2 ** 31:
        raise ValueError("sample index exceeds 31 bits")
    return words


def check_ray_base(ray_base: int, n: int, n_total: int) -> None:
    """A launch's slots [ray_base, ray_base + n) must lie among the
    n_total slots of one chunk of the image."""
    if ray_base < 0 or ray_base + n > n_total:
        raise ValueError(f"slots [{ray_base}, {ray_base + n}) lie outside "
                         f"the {n_total} of one chunk")


def _trace_config(cfg: RenderConfig, table, alb, emi, *, seeds=None,
                  fastmath: bool = False, n_chunks: int = 1,
                  n_rays: int | None = None,
                  ray_base: int = 0) -> _DrtTrace:
    """Check the tables on the card and fill the kernels' config; n_rays
    defaults to the ray slots of one chunk of the image, and ray_base,
    the global index of slot 0, to 0."""
    dev = alb.device
    spp_c = cfg.spp // cfg.spp_chunks
    n_total = cfg.width * cfg.height * spp_c
    n = n_total if n_rays is None else n_rays
    if ray_base:
        check_ray_base(ray_base, n, n_total)
    if alb.ndim != 2 or not 1 <= alb.shape[0] <= MAX_ROWS:
        raise ValueError(f"albedo table {tuple(alb.shape)}: 1..{MAX_ROWS} "
                         "rows of 3")
    if emi.ndim != 2 or not 1 <= emi.shape[0] <= MAX_ROWS:
        raise ValueError(f"emission table {tuple(emi.shape)}: "
                         f"1..{MAX_ROWS} rows of 3")
    _check("albedo table", alb, (alb.shape[0], 3), dev)
    _check("emission table", emi, (emi.shape[0], 3), dev)
    if not 1 <= table.shape[0] <= MAX_SHAPES:
        raise ValueError(f"scene table has {table.shape[0]} shapes; the "
                         f"kernel takes 1..{MAX_SHAPES}")
    _check("scene table", table, (table.shape[0], REC), dev)
    seed_words = _seed_words(seeds, n_chunks * spp_c)
    if 3 * n >= 2 ** 31:
        raise ValueError(f"{n} rays per chunk exceed the kernel's 32-bit "
                         "indexing; raise spp_chunks")
    return _DrtTrace(cfg.width, cfg.height, n, spp_c, n_chunks,
                     cfg.max_depth, cfg.min_bounces, table.shape[0],
                     alb.shape[0], emi.shape[0], int(seeds is not None),
                     int(bool(fastmath)), cfg.absorb_prob,
                     1.0 / (1.0 - cfg.absorb_prob), *seed_words, ray_base)


def _uniform_pointers(tcfg: _DrtTrace, seeds, cam_u, tape, dev):
    """(cam_u, tape) device pointers of tape mode, checked; (None, None)
    for the internal RNG."""
    if seeds is not None:
        return None, None
    if tcfg.n_chunks != 1:
        raise ValueError("tape mode traces one chunk per launch")
    _check("cam_u", cam_u, (2, tcfg.n_rays), dev)
    _check("tape", tape, (tcfg.max_depth, 3, tcfg.n_rays), dev)
    return cam_u.data_ptr(), tape.data_ptr()


def _camera_struct(cc: CameraConsts) -> _DrtCamera:
    return _DrtCamera((ctypes.c_float * 3)(*cc.eye),
                      (ctypes.c_float * 3)(*cc.forward),
                      (ctypes.c_float * 3)(*cc.right),
                      (ctypes.c_float * 3)(*cc.up),
                      cc.aspect_half, cc.half)


def _launch(wrapper, what: str, error_string, entry, dev, *args) -> None:
    """Call a library entry point on the current stream of `dev`, raise
    on a CUDA error, and count the launch on `wrapper` (None for a
    checking build, which is not counted)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + error_string(rc).decode())
    if wrapper is not None:
        wrapper.launches += 1


def fused_trace(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor, *,
                seeds=None, cam_u=None, tape=None, fastmath: bool = False,
                n_chunks: int = 1, build: str = "queue", ray_base: int = 0,
                n_rays: int | None = None) -> torch.Tensor:
    """Radiance f32[3, N] of the fused tracer. CPU tensors run the plain
    twin (which has one form, so `fastmath` and `build` select only the
    kernel); CUDA tensors launch the kernel or raise. build="lockstep"
    launches the checking build of the lockstep loop, which is not
    counted. A shard traces the n_rays slots from ray_base on (by default
    the chunk's W*H*spp_c from 0); a tape holds the shard's slots."""
    entry = _build_entry("drt_fused_trace", build)
    if _device_of("fused_trace", alb) == "cpu":
        return fused_trace_plain(scene, cc, cfg, alb, emi, seeds=seeds,
                                 cam_u=cam_u, tape=tape, n_chunks=n_chunks,
                                 ray_base=ray_base, n_rays=n_rays)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_chunks=n_chunks, n_rays=n_rays,
                         ray_base=ray_base)
    cu_ptr, tape_ptr = _uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    lib = _library()
    out = torch.empty((3, tcfg.n_rays), dtype=torch.float32, device=dev)
    _launch(fused_trace if build == "queue" else None, "fused tracer",
            lib.drt_error_string, getattr(lib, entry), dev,
            ctypes.byref(tcfg), ctypes.byref(_camera_struct(cc)),
            table.data_ptr(), alb.data_ptr(), emi.data_ptr(), cu_ptr,
            tape_ptr, out.data_ptr())
    return out


def _queue_sums(tcfg: _DrtTrace, dev) -> torch.Tensor | None:
    """The collect tracer's queue's scratch for the radiance of each
    (slot, chunk) path, f32[C, 3, N]; None for one chunk, whose paths
    write their slots."""
    if tcfg.n_chunks == 1:
        return None
    return torch.empty((tcfg.n_chunks, 3, tcfg.n_rays), dtype=torch.float32,
                       device=dev)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def fused_collect(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                  cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                  *, seeds=None, cam_u=None, tape=None,
                  fastmath: bool = False, n_chunks: int = 1,
                  build: str = "queue", ray_base: int = 0,
                  n_rays: int | None = None):
    """(radiance f32[3, N], rsc f32[C, D, N], rbest i32[C, D, N]) of the
    collect tracer, the chunk dimension dropped when n_chunks == 1. The
    radiance equals `fused_trace`'s bit for bit. CPU tensors run the
    plain twin; CUDA tensors launch the kernel or raise. build="lockstep"
    launches the checking build of the lockstep loop, which is not
    counted. ray_base and n_rays as `fused_trace`'s."""
    entry = _build_entry("drt_fused_collect", build)
    if _device_of("fused_collect", alb) == "cpu":
        return fused_collect_plain(scene, cc, cfg, alb, emi, seeds=seeds,
                                   cam_u=cam_u, tape=tape,
                                   n_chunks=n_chunks, ray_base=ray_base,
                                   n_rays=n_rays)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_chunks=n_chunks, n_rays=n_rays,
                         ray_base=ray_base)
    cu_ptr, tape_ptr = _uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    lib = _library()
    out, rsc, rbest = _collect_buffers(cfg, tcfg, n_chunks, dev)
    queue = build == "queue"
    sums = _queue_sums(tcfg, dev) if queue else None
    _launch(fused_collect if queue else None, "fused collect tracer",
            lib.drt_error_string, getattr(lib, entry), dev,
            ctypes.byref(tcfg), ctypes.byref(_camera_struct(cc)),
            table.data_ptr(), alb.data_ptr(), emi.data_ptr(), cu_ptr,
            tape_ptr, out.data_ptr(), *((_ptr(sums),) if queue else ()),
            rsc.data_ptr(), rbest.data_ptr())
    return out, rsc, rbest


def _build_entry(entry: str, build: str) -> str:
    if build not in BUILDS:
        raise ValueError(f"build {build!r}: one of {BUILDS}")
    return entry if build == "queue" else f"{entry}_{build}"


def _collect_buffers(cfg: RenderConfig, tcfg: _DrtTrace, n_chunks: int,
                     dev):
    """(out f32[3, N], rsc f32[C, D, N], rbest i32[C, D, N]), the chunk
    dimension dropped when n_chunks == 1; the kernels write every row."""
    n, D = tcfg.n_rays, cfg.max_depth
    res_shape = (D, n) if n_chunks == 1 else (n_chunks, D, n)
    return (torch.empty((3, n), dtype=torch.float32, device=dev),
            torch.empty(res_shape, dtype=torch.float32, device=dev),
            torch.empty(res_shape, dtype=torch.int32, device=dev))


def fused_trace_stats(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                      cfg: RenderConfig, alb: torch.Tensor,
                      emi: torch.Tensor, seeds, *, fastmath: bool = True,
                      n_chunks: int = 1, queue: bool = True,
                      collect: bool = False) -> dict:
    """Run the checking build drt_fused_trace_stats on the card (internal
    RNG; not counted as a launch) and return its counters by name:
    STEP_STATS (queue: lane-trips, warp-trips and their live lanes;
    lockstep: every lane's bounces and the warp-bounces), `cycles` by
    section (SECTIONS; clock64() cycles summed over the warps' steps),
    `live_hist` (lockstep: i64[max_depth, 33], warp-bounces by bounce and
    lanes alive after Russian roulette), `trips` (queue: the lane-trips of
    each ray slot, i32[N]) and `radiance`; with `collect`, also `rsc` and
    `rbest` of the collect tracer's stores."""
    if alb.device.type != "cuda":
        raise ValueError("fused_trace_stats is a checking build of the "
                         "card: it takes CUDA tensors")
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_chunks=n_chunks)
    out, rsc, rbest = _collect_buffers(cfg, tcfg, n_chunks, dev)
    if not collect:
        rsc = rbest = None
    trips = torch.zeros(tcfg.n_rays, dtype=torch.int32, device=dev)
    sums = _queue_sums(tcfg, dev) if collect else None
    n_head = len(STEP_STATS) + N_SECT
    stats = torch.zeros(n_head + 33 * cfg.max_depth, dtype=torch.int64,
                        device=dev)
    lib = _library()
    _launch(None, "fused trace stats", lib.drt_error_string,
            lib.drt_fused_trace_stats, dev, ctypes.byref(tcfg),
            ctypes.byref(_camera_struct(cc)), table.data_ptr(),
            alb.data_ptr(), emi.data_ptr(), out.data_ptr(), _ptr(sums),
            _ptr(rsc), _ptr(rbest), trips.data_ptr(), stats.data_ptr(),
            int(queue))
    head = stats[:n_head].tolist()
    d = dict(zip(STEP_STATS, head))
    d.update(cycles=dict(zip(SECTIONS, head[len(STEP_STATS):])),
             live_hist=stats[n_head:].reshape(cfg.max_depth, 33),
             trips=trips if queue else None, radiance=out)
    if collect:
        d.update(rsc=rsc, rbest=rbest)
    return d


def trip_counts_plain(cfg: RenderConfig, rbest: torch.Tensor, *,
                      seeds=None, tape=None) -> torch.Tensor:
    """The lane-trips each ray slot takes in the tracers' queue, i32[N]:
    summed over the chunks, 1 + the bounces b >= 1 at which the path was
    alive after bounce b - 1 (rbest > 0) and passed Russian roulette (b <
    min_bounces, or its draw u_rr >= absorb_prob in f32). rbest is a
    collect tracer's, i32[C, D, N] or [D, N]; the roulette draws are the
    keyed hash of `seeds` at the slot's pixel and sample, or row (b, 0) of
    `tape` f32[D, 3, N] (one chunk). On the tensors' device."""
    if rbest.ndim == 2:
        rbest = rbest[None]
    n_chunks, D, n = rbest.shape
    if (seeds is None) == (tape is None):
        raise ValueError("pass seeds (internal RNG) or tape")
    if tape is not None and n_chunks != 1:
        raise ValueError("tape mode has one chunk")
    dev = rbest.device
    npix = cfg.width * cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    absorb = torch.tensor(cfg.absorb_prob, dtype=torch.float32, device=dev)
    trips = torch.full((n,), n_chunks, dtype=torch.int32, device=dev)
    for c in range(n_chunks):
        for b in range(1, D):  # a bounce at a time: N-sized temporaries
            if tape is not None:
                u_rr = tape[b, 0].to(torch.float32)
            else:
                u_rr = hash_uniform(int(seeds[1]), slot % npix,
                                    c * spp_c + slot // npix, b, 0,
                                    torch.float32, dev)
            passes = ~(u_rr < absorb) if b >= cfg.min_bounces else True
            trips += (rbest[c, b - 1] > 0) & passes
    return trips


def _adjoint_buffers(cfg: RenderConfig, tcfg: _DrtTrace, g: torch.Tensor,
                     dev):
    """Check the cotangent for the adjoint kernels; allocate the
    per-block partials and the gradient tables. Any depth: beyond
    MAX_DEPTH the kernels take their deep forms (`deep_scratch`)."""
    npix = cfg.width * cfg.height
    if g.ndim != 2 or g.shape[1] not in (tcfg.n_rays, npix):
        raise ValueError(f"g has shape {tuple(g.shape)}, expected "
                         f"(3, {tcfg.n_rays}) per ray or (3, {npix}) per "
                         "pixel")
    if tcfg.ray_base and g.shape[1] != tcfg.n_rays:
        raise ValueError("a launch from ray_base > 0 takes its slots' "
                         f"cotangent per ray, (3, {tcfg.n_rays})")
    _check("g", g, (3, g.shape[1]), dev)
    entries = (tcfg.n_alb - 1 + tcfg.n_emi - 1) * 3
    n_blocks = -(-tcfg.n_rays // BLOCK)
    partials = torch.empty((n_blocks, entries), dtype=torch.float32,
                           device=dev)
    da = torch.empty((tcfg.n_alb, 3), dtype=torch.float32, device=dev)
    de = torch.empty((tcfg.n_emi, 3), dtype=torch.float32, device=dev)
    return partials, da, de


def _slot_columns(tcfg: _DrtTrace, dev) -> torch.Tensor:
    """The adjoint queue's scratch: a row per ray slot of its accumulator
    column, f32[N, E'] with E = 3 x (real albedo + emission rows) rounded
    up to a multiple of 4 (fused_adjoint.cu:slot_stride); 236 MB at the
    Cornell box's main shape, 4 x 380 x N bytes at the tables' limit."""
    entries = (tcfg.n_alb - 1 + tcfg.n_emi - 1) * 3
    return torch.empty((tcfg.n_rays, (entries + 3) // 4 * 4),
                       dtype=torch.float32, device=dev)


def _queue_scratch(lib, cfg: RenderConfig, tcfg: _DrtTrace, dev) -> tuple:
    """The adjoint queue's scratch: its slot columns and, beyond MAX_DEPTH
    bounces, its deep form's rows (None up to it). The caller holds both
    until the launch is queued, so neither takes the other's memory."""
    return (_slot_columns(tcfg, dev),
            deep_scratch(lib, tcfg.n_rays, cfg.max_depth, tcfg.n_alb,
                         tcfg.n_emi, dev))


def fused_sweep_stages(n_alb: int, n_emi: int, max_depth: int) -> int:
    """The ring stages `fused_sweep`'s kernel launches with on the
    current card for tables of n_alb and n_emi rows (the sentinel rows
    included): 3 up to the tables' 63 + 63 real rows; 0 means its rows
    come through registers."""
    return _stages(_adjoint_library().drt_fused_sweep_stages,
                   "fused sweep stages", n_alb, n_emi, max_depth)


def fused_sweep(scene: Scene, table: torch.Tensor, cfg: RenderConfig,
                alb: torch.Tensor, emi: torch.Tensor, rsc: torch.Tensor,
                rbest: torch.Tensor, g: torch.Tensor, *, n_chunks: int = 1,
                n_rays: int | None = None):
    """(d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of the sweep adjoint
    from the collect tracer's residuals and a cotangent g. CPU tensors run
    the plain twin; CUDA tensors launch the kernel or raise. The kernel
    reads a slot's rows up to its first dead row (rbest == 0) and no
    further. It takes each slot's first rows through a ring in shared
    memory, sized at launch from what the table rows' accumulator leaves
    (`fused_sweep_stages`: 3 stages up to the tables' 63 + 63 real rows),
    and takes them through registers where fewer than two stages fit.
    The sweep draws nothing: a shard's sweep takes its n_rays slots'
    residuals and their cotangent per ray, and no ray offset."""
    if _device_of("fused_sweep", alb) == "cpu":
        return fused_sweep_plain(scene, cfg, alb, emi, rsc, rbest, g)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, n_chunks=n_chunks,
                         n_rays=n_rays)
    n, D = tcfg.n_rays, cfg.max_depth
    res_shape = (D, n) if n_chunks == 1 else (n_chunks, D, n)
    _check("rsc", rsc, res_shape, dev)
    _check("rbest", rbest, res_shape, dev, torch.int32)
    partials, da, de = _adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    deep = deep_scratch(lib, n, D, tcfg.n_alb, tcfg.n_emi, dev)
    _launch(fused_sweep, "fused sweep adjoint",
            lib.drt_adjoint_error_string, lib.drt_fused_sweep, dev,
            ctypes.byref(tcfg), table.data_ptr(), alb.data_ptr(),
            emi.data_ptr(), rsc.data_ptr(), rbest.data_ptr(), g.data_ptr(),
            g.shape[1], _ptr(deep), partials.data_ptr(), da.data_ptr(),
            de.data_ptr())
    return da, de


def fused_adjoint(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                  cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                  g: torch.Tensor, *, seeds=None, cam_u=None, tape=None,
                  fastmath: bool = False, n_chunks: int = 1,
                  build: str = "queue", ray_base: int = 0,
                  n_rays: int | None = None):
    """(d_albedo, d_emission) of the retrace adjoint: the forward traced
    again in the kernel from `seeds` (or `cam_u`, `tape`), then the sweep.
    CPU tensors run the plain twin (`build` selects only the kernel); CUDA
    tensors launch the kernel or raise. build="lockstep" launches the
    checking build of the lockstep loop, which is not counted. ray_base
    and n_rays as `fused_trace`'s; from ray_base > 0, g is per ray."""
    entry = _build_entry("drt_fused_adjoint", build)
    if _device_of("fused_adjoint", alb) == "cpu":
        return fused_adjoint_plain(scene, cc, cfg, alb, emi, g, seeds=seeds,
                                   cam_u=cam_u, tape=tape,
                                   n_chunks=n_chunks, ray_base=ray_base,
                                   n_rays=n_rays)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_chunks=n_chunks, n_rays=n_rays,
                         ray_base=ray_base)
    cu_ptr, tape_ptr = _uniform_pointers(tcfg, seeds, cam_u, tape, dev)
    queue = build == "queue"
    if not queue and cfg.max_depth > MAX_DEPTH:
        raise ValueError(f"the lockstep build keeps at most {MAX_DEPTH} "
                         "rows a path in the thread")
    partials, da, de = _adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    scratch = _queue_scratch(lib, cfg, tcfg, dev) if queue else ()
    _launch(fused_adjoint if queue else None, "fused retrace adjoint",
            lib.drt_adjoint_error_string, getattr(lib, entry), dev,
            ctypes.byref(tcfg), ctypes.byref(_camera_struct(cc)),
            table.data_ptr(), alb.data_ptr(), emi.data_ptr(), cu_ptr,
            tape_ptr, g.data_ptr(), g.shape[1], *map(_ptr, scratch),
            partials.data_ptr(), da.data_ptr(), de.data_ptr())
    return da, de


def fused_adjoint_stats(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                        cfg: RenderConfig, alb: torch.Tensor,
                        emi: torch.Tensor, g: torch.Tensor, seeds, *,
                        fastmath: bool = True, n_chunks: int = 1,
                        queue: bool = True) -> dict:
    """Run the timing build drt_fused_adjoint_stats on the card (internal
    RNG; not counted as a launch): the retrace adjoint's queue, or its
    lockstep loop, with a clock at each section. Returns STEP_STATS (queue:
    lane-trips, warp-trips and their live lanes; lockstep: every lane's
    bounces and the warp-bounces), `cycles` by ADJOINT_SECTIONS (clock64()
    cycles summed over the warps; "reduce" is the block reduction of the
    lockstep loop, the flush of a slot's column in the queue) and the
    gradient tables `grads`."""
    if alb.device.type != "cuda":
        raise ValueError("fused_adjoint_stats is a checking build of the "
                         "card: it takes CUDA tensors")
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_chunks=n_chunks)
    partials, da, de = _adjoint_buffers(cfg, tcfg, g, dev)
    slot_acc = _slot_columns(tcfg, dev)
    n_steps = len(STEP_STATS)
    stats = torch.zeros(n_steps + len(ADJOINT_SECTIONS), dtype=torch.int64,
                        device=dev)
    lib = _adjoint_library()
    _launch(None, "fused adjoint stats", lib.drt_adjoint_error_string,
            lib.drt_fused_adjoint_stats, dev, ctypes.byref(tcfg),
            ctypes.byref(_camera_struct(cc)), table.data_ptr(),
            alb.data_ptr(), emi.data_ptr(), g.data_ptr(), g.shape[1],
            slot_acc.data_ptr(), partials.data_ptr(), da.data_ptr(),
            de.data_ptr(), stats.data_ptr(), int(queue))
    head = stats.tolist()
    d = dict(zip(STEP_STATS, head))
    d.update(cycles=dict(zip(ADJOINT_SECTIONS, head[n_steps:])),
             grads=(da, de))
    return d


def _stack3(v) -> torch.Tensor:
    """A V3 of f[N] (or an f[3, N] tensor) as one f[3, N] tensor."""
    return v if torch.is_tensor(v) else torch.stack(tuple(v))


def ray_trace_plain(scene: Scene, cfg: RenderConfig, alb: torch.Tensor,
                    emi: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
    """The plain twin of the wavefront tracer: `renderer.trace_rays` on
    rays o, d f[3, N] and the tape u f[D, 3, N]; radiance f[3, N]."""
    params = Params(albedo=alb[:-1], emission=emi[:-1])
    return torch.stack(trace_rays(params, scene, V3(*o), V3(*d), cfg,
                                  tape=u))


def ray_trace_keyed_plain(scene: Scene, cfg: RenderConfig,
                          alb: torch.Tensor, emi: torch.Tensor,
                          o: torch.Tensor, d: torch.Tensor, seeds,
                          pix: torch.Tensor,
                          sample: torch.Tensor) -> torch.Tensor:
    """The plain twin of the wavefront tracer's keyed form: key-mode
    `renderer.trace_rays` on rays o, d f[3, N] whose bounce draws are those
    of (seeds[1], pix, sample) (i32 or i64 [N] each); radiance f[3, N]."""
    params = Params(albedo=alb[:-1], emission=emi[:-1])
    return torch.stack(trace_rays(params, scene, V3(*o), V3(*d), cfg,
                                  seeds=seeds, pix=pix, sample=sample))


def ray_adjoint_plain(scene: Scene, cfg: RenderConfig, alb: torch.Tensor,
                      emi: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                      u: torch.Tensor, g: torch.Tensor):
    """The plain twin of the wavefront adjoint: `trace_rays(collect=True)`
    and `adjoint._param_grads` with the per-ray cotangent g f[3, N], on
    tables padded to the kernel's (d_albedo f[K+1, 3], d_emission f[L+1,
    3]) with zero sentinel rows."""
    from drt_tpu_torch.adjoint import _param_grads

    params = Params(albedo=alb[:-1], emission=emi[:-1])
    _, res = trace_rays(params, scene, V3(*o), V3(*d), cfg, tape=u,
                        collect=True)
    grads = _param_grads(params, scene, res, V3(*g), alb.dtype)
    zero = alb.new_zeros((1, 3))
    return (torch.cat([grads.albedo, zero]),
            torch.cat([grads.emission, zero]))


def _ray_inputs(tcfg: _DrtTrace, o, d, u, dev) -> None:
    n = tcfg.n_rays
    _check("o", o, (3, n), dev)
    _check("d", d, (3, n), dev)
    if u is not None:
        _check("tape", u, (tcfg.max_depth, 3, n), dev)


def ray_trace(scene: Scene, table: torch.Tensor, cfg: RenderConfig,
              alb: torch.Tensor, emi: torch.Tensor, o: torch.Tensor,
              d: torch.Tensor, u: torch.Tensor | None = None, *, seeds=None,
              pix: torch.Tensor | None = None,
              sample: torch.Tensor | None = None,
              build: str = "queue") -> torch.Tensor:
    """Radiance f32[3, N] of the wavefront tracer on rays o, d f32[3, N].

    Tape form: the bounce draws from the tape u f32[D, 3, N]. Keyed form
    (seeds, pix, sample instead of u): ray i draws bounce b's (rr, u1, u2)
    in the kernel from the keyed hash of (seeds[1], pix[i], sample[i], b),
    pix and sample i32[N] on the card (the rays' pixel and sample, as
    `renderer.chunk_sample_ids` gives them: passed, not derived, so that
    any ray layout draws right); it equals the tape form fed
    `bounce_tape(seeds[1], pix, sample, D)` bit for bit, and reads 8 bytes
    a ray where the tape is 12 D. CPU tensors run the plain twin (key-mode
    `trace_rays` for the keyed form); CUDA tensors launch the kernel
    (exact variant, the only one) or raise. build="lockstep" launches the
    checking build of the lockstep loop (tape form only), which is not
    counted."""
    keyed = seeds is not None or pix is not None or sample is not None
    if keyed == (u is not None) or (keyed and (seeds is None or pix is None
                                               or sample is None)):
        raise TypeError("ray_trace takes a tape u, or seeds, pix and "
                        "sample")
    entry = _build_entry("drt_ray_trace", build)
    if keyed and build != "queue":
        raise ValueError("the lockstep build takes a tape")
    if _device_of("ray_trace", alb) == "cpu":
        if keyed:
            return ray_trace_keyed_plain(scene, cfg, alb, emi, o, d, seeds,
                                         pix, sample)
        return ray_trace_plain(scene, cfg, alb, emi, o, d, u)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         n_rays=o.shape[-1])
    _ray_inputs(tcfg, o, d, u, dev)
    if keyed:
        _check("pix", pix, (tcfg.n_rays,), dev, torch.int32)
        _check("sample", sample, (tcfg.n_rays,), dev, torch.int32)
        entry, draws = "drt_ray_trace_keyed", (pix, sample)
    else:
        draws = (u,)
    lib = _library()
    out = torch.empty((3, tcfg.n_rays), dtype=torch.float32, device=dev)
    _launch(ray_trace if build == "queue" else None, "wavefront tracer",
            lib.drt_error_string, getattr(lib, entry), dev,
            ctypes.byref(tcfg), table.data_ptr(), alb.data_ptr(),
            emi.data_ptr(), o.data_ptr(), d.data_ptr(),
            *(t.data_ptr() for t in draws), out.data_ptr())
    return out


def ray_adjoint(scene: Scene, table: torch.Tensor, cfg: RenderConfig,
                alb: torch.Tensor, emi: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor, u: torch.Tensor, g: torch.Tensor, *,
                build: str = "queue"):
    """(d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of the wavefront
    adjoint: the wavefront tracer's paths retraced, swept back with the
    per-ray cotangent g f32[3, N] and reduced in one launch (and the
    partials' second kernel). CPU tensors run the plain twin (`build`
    selects only the kernel); CUDA tensors launch the kernel or raise.
    build="lockstep" launches the checking build of the lockstep loop,
    which is not counted."""
    entry = _build_entry("drt_ray_adjoint", build)
    if _device_of("ray_adjoint", alb) == "cpu":
        return ray_adjoint_plain(scene, cfg, alb, emi, o, d, u, g)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, n_rays=o.shape[-1])
    _ray_inputs(tcfg, o, d, u, dev)
    _check("g", g, (3, tcfg.n_rays), dev)  # one cotangent per ray
    queue = build == "queue"
    if not queue and cfg.max_depth > MAX_DEPTH:
        raise ValueError(f"the lockstep build keeps at most {MAX_DEPTH} "
                         "rows a path in the thread")
    partials, da, de = _adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    scratch = _queue_scratch(lib, cfg, tcfg, dev) if queue else ()
    _launch(ray_adjoint if queue else None, "wavefront adjoint",
            lib.drt_adjoint_error_string, getattr(lib, entry), dev,
            ctypes.byref(tcfg), table.data_ptr(), alb.data_ptr(),
            emi.data_ptr(), o.data_ptr(), d.data_ptr(), u.data_ptr(),
            g.data_ptr(), *map(_ptr, scratch), partials.data_ptr(),
            da.data_ptr(), de.data_ptr())
    return da, de


# ---------------------------------------------------------------------------
# Segment forms [b_start, b_end) of the tracer and the retrace adjoint.
#
# A segment is entered from the camera (b_start == 0: lane i is ray slot i)
# or from a state: ray f32[9, K] (origin, direction, throughput rows) and
# alive i32[K], as the previous segment left it, and it leaves that state
# unless b_end == max_depth. With the internal RNG a lane draws bounce b's
# uniforms from the keyed hash at the absolute bounce b, for the ray slot
# ray_idx i32[K] of chunk `chunk` (pixel ray_idx % (W*H), sample
# chunk * spp_c + ray_idx // (W*H)); so a compacted wavefront follows the
# paths of the lockstep tracer sample for sample. Tape mode reads row
# b - b_start of a segment tape f[b_end - b_start, 3, K] at the lane.
# ---------------------------------------------------------------------------

def _check_segment(cfg: RenderConfig, b_start: int, b_end: int) -> None:
    if not 0 <= b_start < b_end <= cfg.max_depth:
        raise ValueError(f"segment [{b_start}, {b_end}) is not inside "
                         f"[0, {cfg.max_depth})")


def _segment_entry(cc: CameraConsts, cfg: RenderConfig, b_start: int,
                   K: int, seeds, cam_u, ray, alive, ray_idx, chunk: int,
                   dtype, dev):
    """A segment's lanes at entry: (o, d, T, alive bool[K]; T and alive
    None for fresh camera rays) and their (pixel, sample) i64[K], None in
    tape mode past the camera."""
    npix = cfg.width * cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    r = (torch.arange(K, device=dev) if b_start == 0 else
         None if ray_idx is None else ray_idx.long())
    pix = smp = None
    if r is not None:
        pix = r % npix
        smp = chunk * spp_c + r // npix
    if b_start == 0:
        if seeds is not None:
            cam_u = camera_draws(_seed_words(seeds, 0)[0], pix, smp, dtype)
        o, d = camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
        return o, d, None, None, pix, smp
    return (V3(*ray[0:3]), V3(*ray[3:6]), V3(*ray[6:9]), alive > 0, pix,
            smp)


def segment_trace_plain(scene: Scene, cc: CameraConsts, cfg: RenderConfig,
                        b_start: int, b_end: int, alb: torch.Tensor,
                        emi: torch.Tensor, *, seeds=None, cam_u=None,
                        tape=None, ray=None, alive=None, ray_idx=None,
                        chunk: int = 0, n_rays: int | None = None,
                        collect: bool = False):
    """The plain twin of the segment tracer: `renderer.trace_segment` on
    the segment's entry state and uniforms. Returns radiance f[3, K], with
    the exit state (ray f[9, K], alive i32[K]) unless b_end == max_depth;
    collect=True returns (radiance, BounceResiduals) instead."""
    _check_segment(cfg, b_start, b_end)
    K = (cfg.width * cfg.height * (cfg.spp // cfg.spp_chunks)
         if n_rays is None else n_rays)
    o, d, T, live, pix, smp = _segment_entry(
        cc, cfg, b_start, K, seeds, cam_u, ray, alive, ray_idx, chunk,
        alb.dtype, alb.device)
    if seeds is not None:
        tape = bounce_tape(_seed_words(seeds, 0)[1], pix, smp, b_end,
                           alb.dtype, first=b_start)
    L, (o, d, T, live), res, _ = trace_segment(
        Params(albedo=alb[:-1], emission=emi[:-1]), scene, cfg, b_start,
        b_end, o, d, T, live, tape)
    L = torch.stack(tuple(L))
    if collect:
        return L, res
    if b_end == cfg.max_depth:
        return L
    return L, (torch.stack([*o, *d, *T]), live.to(torch.int32))


def segment_adjoint_plain(scene: Scene, cc: CameraConsts, cfg: RenderConfig,
                          b_start: int, b_end: int, alb: torch.Tensor,
                          emi: torch.Tensor, g: torch.Tensor, *,
                          S_end=None, **entry):
    """The plain twin of the segment adjoint: the segment retraced
    (`segment_trace_plain(collect=True)`, fed `entry`: the uniforms,
    state, ray index, chunk and lane count), then the reverse sweep
    (`adjoint._reverse_sweep`) seeded by S_end f[3, K] (zero for the last
    segment). g is f[3, K] per lane, or f[3, W*H] per pixel when
    b_start == 0. Returns (d_albedo f[K+1, 3], d_emission f[L+1, 3]),
    sentinel rows zero, and S_start f[3, K] when b_start > 0."""
    from drt_tpu_torch.adjoint import _reverse_sweep

    _, res = segment_trace_plain(scene, cc, cfg, b_start, b_end, alb, emi,
                                 collect=True, **entry)
    K = res.sc.shape[1]
    S = None if S_end is None else V3(*S_end)
    da, de, S = _reverse_sweep(alb, emi, res, V3(*_per_ray(g, K)), S)
    da, de = da.to_array(), de.to_array()
    da[-1] = 0.0
    de[-1] = 0.0
    if b_start == 0:
        return da, de
    return da, de, torch.stack(tuple(S))


def segment_trace_form(b_start: int) -> str:
    """The loop `fused_segment_trace` runs for a segment from b_start, as
    its library chooses at each launch: "queue" where lanes can enter dead
    (b_start > 0), else "lockstep"."""
    queue = ctypes.c_int()
    rc = _library().drt_fused_segment_trace_form(b_start,
                                                 ctypes.byref(queue))
    if rc:
        raise RuntimeError(f"segment tracer form query: error {rc}")
    return "queue" if queue.value else "lockstep"


def segment_form(b_start: int, n_shapes: int, n_alb: int,
                 n_emi: int) -> str:
    """The loop `fused_segment_adjoint` runs for a segment from b_start
    in a scene of n_shapes and tables of n_alb and n_emi rows (the
    sentinel rows included) on the current card, as its library chooses
    at each launch: "queue" where lanes can enter dead (b_start > 0) and
    the queue's sums fit in a block's shared memory (up to about 70 real
    table rows), else "lockstep"."""
    queue = ctypes.c_int()
    rc = _adjoint_library().drt_fused_segment_form(
        b_start, n_shapes, n_alb, n_emi, ctypes.byref(queue))
    if rc:
        raise RuntimeError(f"segment form query: CUDA error {rc}")
    return "queue" if queue.value else "lockstep"


def _segment_pointers(cfg: RenderConfig, tcfg: _DrtTrace, b_start: int,
                      b_end: int, seeds, cam_u, tape, ray, alive, ray_idx,
                      chunk: int, dev) -> list:
    """Check a segment's inputs on the card; their pointers (cam_u, tape,
    ray, alive, ray_idx), None where the form takes no such input."""
    K = tcfg.n_rays
    if not 0 <= chunk < cfg.spp_chunks:
        raise ValueError(f"chunk {chunk} outside [0, {cfg.spp_chunks})")
    ptrs = [None] * 5
    if seeds is None:
        if b_start == 0:
            _check("cam_u", cam_u, (2, K), dev)
            ptrs[0] = cam_u.data_ptr()
        _check("tape", tape, (b_end - b_start, 3, K), dev)
        ptrs[1] = tape.data_ptr()
    if b_start > 0:
        _check("ray", ray, (9, K), dev)
        _check("alive", alive, (K,), dev, torch.int32)
        ptrs[2:4] = ray.data_ptr(), alive.data_ptr()
        if seeds is not None:
            _check("ray_idx", ray_idx, (K,), dev, torch.int32)
            ptrs[4] = ray_idx.data_ptr()
    return ptrs


def fused_segment_trace(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                        cfg: RenderConfig, b_start: int, b_end: int,
                        alb: torch.Tensor, emi: torch.Tensor, *, seeds=None,
                        cam_u=None, tape=None, ray=None, alive=None,
                        ray_idx=None, chunk: int = 0,
                        n_rays: int | None = None, fastmath: bool = False,
                        build: str = "queue"):
    """Radiance f32[3, K] of bounces [b_start, b_end) of one chunk, with
    the exit state (ray f32[9, K], alive i32[K]) unless b_end ==
    max_depth. CPU tensors run the plain twin (`build` selects only the
    kernel); CUDA tensors launch the kernel or raise. The kernel is a
    queue of the segment's lanes that spends a trip only on a live bounce
    where lanes can enter dead (b_start > 0), else the lockstep loop
    (every bounce of every lane), as `segment_trace_form` says; a lane
    that is not alive at b_end leaves +0 in its exit ray.
    build="lockstep" launches the lockstep loop at every call, the
    queue's bit reference; it is not counted."""
    entry = _build_entry("drt_fused_segment_trace", build)
    if _device_of("fused_segment_trace", alb) == "cpu":
        return segment_trace_plain(scene, cc, cfg, b_start, b_end, alb, emi,
                                   seeds=seeds, cam_u=cam_u, tape=tape,
                                   ray=ray, alive=alive, ray_idx=ray_idx,
                                   chunk=chunk, n_rays=n_rays)
    _check_segment(cfg, b_start, b_end)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_rays=n_rays)
    ptrs = _segment_pointers(cfg, tcfg, b_start, b_end, seeds, cam_u, tape,
                             ray, alive, ray_idx, chunk, dev)
    K = tcfg.n_rays
    final = b_end == cfg.max_depth
    out = torch.empty((3, K), dtype=torch.float32, device=dev)
    ray_out = alive_out = None
    if not final:
        ray_out = torch.empty((9, K), dtype=torch.float32, device=dev)
        alive_out = torch.empty((K,), dtype=torch.int32, device=dev)
    lib = _library()
    _launch(fused_segment_trace if build == "queue" else None,
            "fused segment tracer", lib.drt_error_string,
            getattr(lib, entry), dev, ctypes.byref(tcfg),
            ctypes.byref(_camera_struct(cc)), b_start, b_end, chunk,
            table.data_ptr(), alb.data_ptr(), emi.data_ptr(), *ptrs,
            out.data_ptr(), None if final else ray_out.data_ptr(),
            None if final else alive_out.data_ptr())
    return out if final else (out, (ray_out, alive_out))


def fused_segment_adjoint(scene: Scene, table: torch.Tensor,
                          cc: CameraConsts, cfg: RenderConfig, b_start: int,
                          b_end: int, alb: torch.Tensor, emi: torch.Tensor,
                          g: torch.Tensor, *, S_end=None, seeds=None,
                          cam_u=None, tape=None, ray=None, alive=None,
                          ray_idx=None, chunk: int = 0,
                          n_rays: int | None = None,
                          fastmath: bool = False, build: str = "queue"):
    """(d_albedo f32[K+1, 3], d_emission f32[L+1, 3][, S_start f32[3, K]])
    of bounces [b_start, b_end): the segment retraced in the kernel, the
    reverse sweep seeded by S_end (given iff b_end < max_depth), S at the
    segment's entry returned iff b_start > 0. g is f32[3, K] per lane, or
    f32[3, W*H] per pixel when b_start == 0. CPU tensors run the plain
    twin (`build` selects only the kernel); CUDA tensors launch the kernel
    or raise. The kernel is a queue of the segment's lanes that spends a
    trip only on a live bounce where lanes can enter dead (b_start > 0),
    else the lockstep loop (every bounce of every lane), as
    `segment_form` says. build="lockstep" launches the lockstep loop at
    every call, the queue's bit reference; it is not counted."""
    entry = _build_entry("drt_fused_segment_adjoint", build)
    final = b_end == cfg.max_depth
    if (S_end is None) != final:
        raise ValueError("S_end is given iff the segment ends before "
                         "max_depth")
    if _device_of("fused_segment_adjoint", alb) == "cpu":
        return segment_adjoint_plain(scene, cc, cfg, b_start, b_end, alb,
                                     emi, g, S_end=S_end, seeds=seeds,
                                     cam_u=cam_u, tape=tape, ray=ray,
                                     alive=alive, ray_idx=ray_idx,
                                     chunk=chunk, n_rays=n_rays)
    _check_segment(cfg, b_start, b_end)
    dev = alb.device
    tcfg = _trace_config(cfg, table, alb, emi, seeds=seeds,
                         fastmath=fastmath, n_rays=n_rays)
    ptrs = _segment_pointers(cfg, tcfg, b_start, b_end, seeds, cam_u, tape,
                             ray, alive, ray_idx, chunk, dev)
    K = tcfg.n_rays
    if b_start > 0:
        _check("g", g, (3, K), dev)  # one cotangent per lane
    partials, da, de = _adjoint_buffers(cfg, tcfg, g, dev)
    if not final:
        _check("S_end", S_end, (3, K), dev)
    s_start = (None if b_start == 0 else
               torch.empty((3, K), dtype=torch.float32, device=dev))
    lib = _adjoint_library()
    queue = build == "queue"
    # The entry point's group counter for the queue, an int of scratch.
    next_group = (torch.empty(1, dtype=torch.int32, device=dev),
                  ) if queue else ()
    # A segment of more than MAX_DEPTH bounces takes its loop's deep form.
    deep = deep_scratch(lib, K, b_end - b_start, tcfg.n_alb, tcfg.n_emi,
                        dev)
    _launch(fused_segment_adjoint if queue else None,
            "fused segment adjoint", lib.drt_adjoint_error_string,
            getattr(lib, entry), dev, ctypes.byref(tcfg),
            ctypes.byref(_camera_struct(cc)), b_start, b_end, chunk,
            table.data_ptr(), alb.data_ptr(), emi.data_ptr(), *ptrs,
            g.data_ptr(), g.shape[1], None if final else S_end.data_ptr(),
            *(t.data_ptr() for t in next_group), _ptr(deep),
            partials.data_ptr(), da.data_ptr(), de.data_ptr(),
            None if s_start is None else s_start.data_ptr())
    return (da, de) if s_start is None else (da, de, s_start)


WRAPPERS = {"fused_tracer": fused_trace, "fused_collect": fused_collect,
            "fused_sweep": fused_sweep, "fused_adjoint": fused_adjoint,
            "ray_tracer": ray_trace, "ray_adjoint": ray_adjoint,
            "segment_tracer": fused_segment_trace,
            "segment_adjoint": fused_segment_adjoint}


def register_wrappers(**wrappers) -> None:
    """Join another kernel family's wrappers to the launch counts."""
    for fn in wrappers.values():
        fn.launches = 0
    WRAPPERS.update(wrappers)


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


reset_launch_counts()


def _check_rng(rng: str, n_chunks: int) -> None:
    if rng not in ("internal", "tape"):
        raise ValueError(f"unknown rng {rng!r}")
    if n_chunks != 1 and rng != "internal":
        raise ValueError("chunked tracing is internal-RNG only")


def _uniform_kw(rng: str, args: tuple) -> dict:
    if rng == "internal":
        (seeds,) = args
        return dict(seeds=seeds)
    cam_u, tape = args
    return dict(cam_u=cam_u, tape=tape)


def make_fused_tracer(scene: Scene, cam, cfg: RenderConfig,
                      rng: str = "internal", fastmath: bool = False,
                      n_chunks: int = 1, plain: bool = False,
                      n_rays: int | None = None):
    """Build `trace(alb, emi, seeds)` (rng="internal") or `trace(alb, emi,
    cam_u, tape)` (rng="tape") -> radiance f32[3, N].

    n_chunks > 1 (internal RNG only) runs the spp chunks in one launch
    and sums their radiance per ray slot. plain=True runs the plain twin
    on whatever device the tensors lie on (the "torch" backend). n_rays
    (by default one chunk's W*H*spp_c) is a shard's count of slots, and
    `trace(..., ray_base=k * n_rays)` traces shard k's."""
    _check_rng(rng, n_chunks)
    cc = camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else scene_table(scene)

    def trace(alb, emi, *args, ray_base: int = 0):
        kw = dict(_uniform_kw(rng, args), n_chunks=n_chunks,
                  ray_base=ray_base, n_rays=n_rays)
        if plain:
            return fused_trace_plain(scene, cc, cfg, alb, emi, **kw)
        return fused_trace(scene, table, cc, cfg, alb, emi,
                           fastmath=fastmath, **kw)

    return trace


def make_fused_collect_tracer(scene: Scene, cam, cfg: RenderConfig,
                              rng: str = "internal", fastmath: bool = False,
                              n_chunks: int = 1, plain: bool = False,
                              n_rays: int | None = None):
    """Build `trace(alb, emi, seeds | cam_u, tape) -> (L f32[3, N], rsc,
    rbest)`: the tracer that also stores the adjoint's residuals, 8 bytes
    per bounce-ray (rsc f32, rbest i32, each [D, N], or [C, D, N] for
    n_chunks > 1). L is `make_fused_tracer`'s radiance bit for bit;
    n_rays and ray_base as there."""
    _check_rng(rng, n_chunks)
    cc = camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else scene_table(scene)

    def trace(alb, emi, *args, ray_base: int = 0):
        kw = dict(_uniform_kw(rng, args), n_chunks=n_chunks,
                  ray_base=ray_base, n_rays=n_rays)
        if plain:
            return fused_collect_plain(scene, cc, cfg, alb, emi, **kw)
        return fused_collect(scene, table, cc, cfg, alb, emi,
                             fastmath=fastmath, **kw)

    return trace


def make_fused_sweep_adjoint(scene: Scene, cfg: RenderConfig,
                             n_chunks: int = 1, plain: bool = False,
                             n_rays: int | None = None):
    """Build `sweep(alb, emi, rsc, rbest, g) -> (d_albedo, d_emission)`:
    the backward from the collect tracer's residuals, with g f32[3, N]
    per ray slot (identical across chunks) or f32[3, W*H] per pixel; a
    shard's sweep (n_rays slots) takes its slots' g per ray."""
    table = None if plain else scene_table(scene)

    def sweep(alb, emi, rsc, rbest, g):
        if plain:
            return fused_sweep_plain(scene, cfg, alb, emi, rsc, rbest, g)
        return fused_sweep(scene, table, cfg, alb, emi, rsc, rbest, g,
                           n_chunks=n_chunks, n_rays=n_rays)

    return sweep


def make_fused_adjoint(scene: Scene, cam, cfg: RenderConfig,
                       rng: str = "internal", fastmath: bool = False,
                       n_chunks: int = 1, plain: bool = False,
                       n_rays: int | None = None):
    """Build `adj(alb, emi, seeds, g)` (rng="internal") or `adj(alb, emi,
    cam_u, tape, g)` (rng="tape") -> (d_albedo, d_emission): the retrace
    adjoint. Pass the forward's seeds for biased mode or a fresh seeds[1]
    for unbiased mode (integrate.hpp:39-52). n_rays and ray_base as
    `make_fused_tracer`'s."""
    _check_rng(rng, n_chunks)
    cc = camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else scene_table(scene)

    def adjoint(alb, emi, *args, ray_base: int = 0):
        *uniforms, g = args
        kw = dict(_uniform_kw(rng, tuple(uniforms)), n_chunks=n_chunks,
                  ray_base=ray_base, n_rays=n_rays)
        if plain:
            return fused_adjoint_plain(scene, cc, cfg, alb, emi, g, **kw)
        return fused_adjoint(scene, table, cc, cfg, alb, emi, g,
                             fastmath=fastmath, **kw)

    return adjoint


def make_pallas_tracer(scene: Scene, cfg: RenderConfig, plain: bool = False,
                       keyed: bool = False):
    """Build `trace(alb, emi, o, d, u) -> radiance f32[3, N]`: the bounce
    loop on the primary rays o, d (V3 of f32[N], or f32[3, N]) and the
    uniform tape u f32[D, 3, N], the same as `renderer.trace_rays(...,
    tape=u)` (the JAX package's signature, tests/test_megakernel.py); or,
    keyed=True, `trace(alb, emi, o, d, seeds, pix, sample)`, whose bounce
    draws are drawn in the kernel from the keyed hash of (seeds[1], pix,
    sample) (`ray_trace`'s keyed form), the same as key-mode `trace_rays`.
    The kernel is the exact variant, at most `MAX_SHAPES` shapes and
    `MAX_ROWS` table rows. plain=True runs the plain twin on whatever
    device the tensors lie on (the "torch-wavefront" backend)."""
    table = None if plain else scene_table(scene)

    def trace(alb, emi, o, d, *draws):
        o, d = _stack3(o), _stack3(d)
        if keyed:
            seeds, pix, sample = draws
            if plain:
                return ray_trace_keyed_plain(scene, cfg, alb, emi, o, d,
                                             seeds, pix, sample)
            return ray_trace(scene, table, cfg, alb, emi, o, d, seeds=seeds,
                             pix=pix, sample=sample)
        (u,) = draws
        if plain:
            return ray_trace_plain(scene, cfg, alb, emi, o, d, u)
        return ray_trace(scene, table, cfg, alb, emi, o, d, u)

    return trace


def make_pallas_adjoint(scene: Scene, cfg: RenderConfig, plain: bool = False):
    """Build `adj(alb, emi, o, d, u, g) -> (d_albedo f32[K+1, 3],
    d_emission f32[L+1, 3])`: the parameter gradients of sum_rays g . L
    for the rays and tape of `make_pallas_tracer` and a per-ray cotangent
    g (V3 of f32[N], or f32[3, N]), sentinel rows zero; any depth (past
    `MAX_DEPTH` bounces the kernel's deep form)."""
    table = None if plain else scene_table(scene)

    def adjoint(alb, emi, o, d, u, g):
        o, d, g = _stack3(o), _stack3(d), _stack3(g)
        if plain:
            return ray_adjoint_plain(scene, cfg, alb, emi, o, d, u, g)
        return ray_adjoint(scene, table, cfg, alb, emi, o, d, u, g)

    return adjoint


def _segment_args(rng: str, b_start: int, args: tuple):
    """A segment call's leading positional arguments as keywords: the
    uniforms (seeds, or [cam_u,] u), then, past the camera, the state
    (ray, alive) and, with the internal RNG, ray_idx. Returns (keywords,
    the remaining arguments)."""
    it = iter(args)
    kw = {}
    if rng == "internal":
        kw["seeds"] = next(it)
    else:
        if b_start == 0:
            kw["cam_u"] = next(it)
        kw["tape"] = next(it)
    if b_start > 0:
        kw["ray"] = next(it)
        kw["alive"] = next(it)
        if rng == "internal":
            kw["ray_idx"] = next(it)
    return kw, list(it)


def make_fused_segment_tracer(scene: Scene, cam, cfg: RenderConfig,
                              b_start: int, b_end: int,
                              n_rays: int | None = None,
                              rng: str = "internal", fastmath: bool = False,
                              plain: bool = False, build: str = "queue"):
    """Build the tracer of bounces [b_start, b_end) over K = n_rays lanes
    (default one chunk's W*H*spp_c), the call forms of the JAX package's
    `make_fused_segment_tracer` with the state as (ray f32[9, K], alive
    i32[K]) and, with the internal RNG, each lane's ray slot ray_idx
    i32[K]:
      internal: trace(alb, emi, seeds[, ray, alive, ray_idx], chunk=0)
      tape:     trace(alb, emi[, cam_u], u[, ray, alive])
    (the state iff b_start > 0, cam_u iff b_start == 0, u f32[b_end -
    b_start, 3, K]). Returns radiance f32[3, K], and (L, (ray, alive)) iff
    b_end < max_depth. plain=True runs the plain twin on the tensors'
    device; `build` selects the kernel (BUILDS, `fused_segment_trace`)."""
    _check_segment(cfg, b_start, b_end)
    _check_rng(rng, 1)
    _build_entry("drt_fused_segment_trace", build)
    cc = camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else scene_table(scene)

    def trace(alb, emi, *args, chunk: int = 0):
        kw, rest = _segment_args(rng, b_start, args)
        if rest:
            raise TypeError(f"{len(rest)} arguments too many for segment "
                            f"[{b_start}, {b_end})")
        if plain:
            return segment_trace_plain(scene, cc, cfg, b_start, b_end, alb,
                                       emi, chunk=chunk, n_rays=n_rays, **kw)
        return fused_segment_trace(scene, table, cc, cfg, b_start, b_end,
                                   alb, emi, chunk=chunk, n_rays=n_rays,
                                   fastmath=fastmath, build=build, **kw)

    return trace


def make_fused_segment_adjoint(scene: Scene, cam, cfg: RenderConfig,
                               b_start: int, b_end: int,
                               n_rays: int | None = None,
                               rng: str = "internal", fastmath: bool = False,
                               plain: bool = False, build: str = "queue"):
    """Build the retrace adjoint of bounces [b_start, b_end), the call
    forms of the JAX package's `make_fused_segment_adjoint`:
      internal: adj(alb, emi, seeds[, ray, alive, ray_idx], g[, S_end],
                    chunk=0)
      tape:     adj(alb, emi[, cam_u], u[, ray, alive], g[, S_end])
    with S_end f32[3, K] iff b_end < max_depth; g f32[3, K] per lane, or
    f32[3, W*H] per pixel when b_start == 0. Returns (d_albedo,
    d_emission), with S_start f32[3, K] after them iff b_start > 0.
    `build` selects the kernel (BUILDS, `fused_segment_adjoint`)."""
    _check_segment(cfg, b_start, b_end)
    _check_rng(rng, 1)
    cc = camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else scene_table(scene)
    final = b_end == cfg.max_depth

    def adjoint(alb, emi, *args, chunk: int = 0):
        kw, rest = _segment_args(rng, b_start, args)
        if len(rest) != (1 if final else 2):
            raise TypeError(f"segment [{b_start}, {b_end}) takes g"
                            + ("" if final else " and S_end")
                            + " after the state")
        g, *S_end = rest
        S_end = S_end[0] if S_end else None
        if plain:
            return segment_adjoint_plain(scene, cc, cfg, b_start, b_end, alb,
                                         emi, g, S_end=S_end, chunk=chunk,
                                         n_rays=n_rays, **kw)
        return fused_segment_adjoint(scene, table, cc, cfg, b_start, b_end,
                                     alb, emi, g, S_end=S_end, chunk=chunk,
                                     n_rays=n_rays, fastmath=fastmath,
                                     build=build, **kw)

    return adjoint
