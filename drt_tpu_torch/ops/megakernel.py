"""The fused forward tracer: a CUDA kernel and its plain PyTorch twin.

The port of `drt_tpu.ops.megakernel.make_fused_tracer` (the Pallas
kernel `make_fused_segment_tracer` at full depth): camera ray generation,
sampling and the whole `max_depth` bounce loop in one launch, radiance
f32[3, N] out, N = W*H*spp/spp_chunks ray slots, summed over the spp
chunks. The kernel is `csrc/fused_tracer.cu`; its source note says what
bounds it and how its design differs from the TPU kernel's.

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

`fused_trace` is the wrapper: for tensors on the CPU it runs the plain
twin (the fused camera math, then `renderer.trace_rays(tape=...)`, fed
the same uniforms); for CUDA tensors it launches the kernel or raises.
`fused_trace.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops.rng import hash_tapes
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.renderer import trace_rays
from drt_tpu_torch.scene import Params, Scene, SPHERE, TRIANGLE

SOURCE = "fused_tracer.cu"
# Bounds of the kernel's shared-memory tables (DRT_* in the source).
MAX_SHAPES = 64
MAX_ROWS = 64
REC = 32
# Shape record layout (R_* in the source).
R_TYPE, R_MAT, R_ALB, R_EMI, R_GEO = 0, 1, 2, 3, 4
R_E1, R_E2, R_TRI_N, R_R2 = 16, 19, 22, 25
R_EXPO, R_INV_E2, R_POW_MODE = 26, 27, 28
POW_NONINT, POW_EVEN, POW_ODD = 0, 1, 2


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
                         "memory-resident kernels (ROADMAP A11, B6)")
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


def fused_trace_plain(scene: Scene, cc: CameraConsts, cfg: RenderConfig,
                      alb: torch.Tensor, emi: torch.Tensor, *, seeds=None,
                      cam_u=None, tape=None, n_chunks: int = 1
                      ) -> torch.Tensor:
    """The plain PyTorch twin of the kernel, on the tensors' device.
    Pass `seeds` (internal RNG, any n_chunks) or `cam_u` and `tape`.
    Returns radiance f[3, N] summed over the chunks."""
    npix = cfg.width * cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    n = npix * spp_c
    params = Params(albedo=alb[:-1], emission=emi[:-1])
    pix = torch.arange(n, device=alb.device) % npix
    L = None
    for c in range(n_chunks):
        if seeds is not None:
            cam_u, tape = hash_tapes(seeds, npix, spp_c, cfg.max_depth,
                                     alb.dtype, sample_base=c * spp_c,
                                     device=alb.device)
        o, d = camera_ray_from_pix(cc, pix, cam_u[0], cam_u[1])
        Lc = torch.stack(trace_rays(params, scene, o, d, cfg, tape=tape))
        L = Lc if L is None else L + Lc
    return L


class _DrtCamera(ctypes.Structure):
    _fields_ = [("eye", ctypes.c_float * 3), ("fwd", ctypes.c_float * 3),
                ("right", ctypes.c_float * 3), ("up", ctypes.c_float * 3),
                ("aspect_half", ctypes.c_float), ("half", ctypes.c_float)]


class _DrtTrace(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "width", "height", "n_rays", "spp_c", "n_chunks", "max_depth",
        "min_bounces", "n_shapes", "n_alb", "n_emi", "internal_rng",
        "fast")] + [("absorb", ctypes.c_float), ("inv_keep", ctypes.c_float),
                    ("seed0", ctypes.c_uint32), ("seed1", ctypes.c_uint32)]


def _library() -> ctypes.CDLL:
    from drt_tpu_torch.utils import native

    lib = native.load(SOURCE)
    if lib.drt_fused_trace.argtypes is None:
        vp = ctypes.c_void_p
        lib.drt_fused_trace.argtypes = [ctypes.POINTER(_DrtTrace),
                                        ctypes.POINTER(_DrtCamera),
                                        vp, vp, vp, vp, vp, vp, vp]
        lib.drt_fused_trace.restype = ctypes.c_int
        lib.drt_error_string.argtypes = [ctypes.c_int]
        lib.drt_error_string.restype = ctypes.c_char_p
        ip = ctypes.POINTER(ctypes.c_int)
        lib.drt_limits.argtypes = [ip, ip, ip]
        lib.drt_limits.restype = ctypes.c_int
        got = [ctypes.c_int() for _ in range(3)]
        lib.drt_limits(*(ctypes.byref(v) for v in got))
        if [v.value for v in got] != [MAX_SHAPES, MAX_ROWS, REC]:
            raise RuntimeError(f"{SOURCE} bounds {[v.value for v in got]} "
                               f"differ from the wrapper's "
                               f"{[MAX_SHAPES, MAX_ROWS, REC]}")
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_trace(scene: Scene, table: torch.Tensor, cc: CameraConsts,
                cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor, *,
                seeds=None, cam_u=None, tape=None, fastmath: bool = False,
                n_chunks: int = 1) -> torch.Tensor:
    """Radiance f32[3, N] of the fused tracer. CPU tensors run the plain
    twin (which has one form, so `fastmath` selects only the kernel's
    variant); CUDA tensors launch the kernel or raise."""
    if alb.device.type == "cpu":
        return fused_trace_plain(scene, cc, cfg, alb, emi, seeds=seeds,
                                 cam_u=cam_u, tape=tape, n_chunks=n_chunks)
    if alb.device.type != "cuda":
        raise ValueError(f"fused_trace runs on cpu or cuda, not "
                         f"{alb.device.type}")
    dev = alb.device
    spp_c = cfg.spp // cfg.spp_chunks
    n = cfg.width * cfg.height * spp_c
    D = cfg.max_depth
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
    internal = seeds is not None
    if internal:
        seed_words = [int(v) & 0xFFFFFFFF for v in
                      (seeds.tolist() if torch.is_tensor(seeds) else seeds)]
        if len(seed_words) != 2:
            raise ValueError("seeds must hold 2 words (camera, bounce)")
        if n_chunks * spp_c >= 2 ** 31:
            raise ValueError("sample index exceeds 31 bits")
        cu_ptr = tape_ptr = None
    else:
        if n_chunks != 1:
            raise ValueError("tape mode traces one chunk per launch")
        _check("cam_u", cam_u, (2, n), dev)
        _check("tape", tape, (D, 3, n), dev)
        seed_words = [0, 0]
        cu_ptr, tape_ptr = cam_u.data_ptr(), tape.data_ptr()
    if 3 * n >= 2 ** 31:
        raise ValueError(f"{n} rays per chunk exceed the kernel's 32-bit "
                         "indexing; raise spp_chunks")

    lib = _library()
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    tcfg = _DrtTrace(cfg.width, cfg.height, n, spp_c,
                     n_chunks, D, cfg.min_bounces, table.shape[0],
                     alb.shape[0], emi.shape[0], int(internal),
                     int(bool(fastmath)), cfg.absorb_prob,
                     1.0 / (1.0 - cfg.absorb_prob), *seed_words)
    ccam = _DrtCamera((ctypes.c_float * 3)(*cc.eye),
                      (ctypes.c_float * 3)(*cc.forward),
                      (ctypes.c_float * 3)(*cc.right),
                      (ctypes.c_float * 3)(*cc.up),
                      cc.aspect_half, cc.half)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.drt_fused_trace(ctypes.byref(tcfg), ctypes.byref(ccam),
                                 table.data_ptr(), alb.data_ptr(),
                                 emi.data_ptr(), cu_ptr, tape_ptr,
                                 out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("fused tracer launch failed: "
                           + lib.drt_error_string(rc).decode())
    fused_trace.launches += 1
    return out


fused_trace.launches = 0


def make_fused_tracer(scene: Scene, cam, cfg: RenderConfig,
                      rng: str = "internal", fastmath: bool = False,
                      n_chunks: int = 1, plain: bool = False):
    """Build `trace(alb, emi, seeds)` (rng="internal") or `trace(alb, emi,
    cam_u, tape)` (rng="tape") -> radiance f32[3, N].

    n_chunks > 1 (internal RNG only) runs the spp chunks in one launch
    and sums their radiance per ray slot. plain=True runs the plain twin
    on whatever device the tensors lie on (the "torch" backend)."""
    if rng not in ("internal", "tape"):
        raise ValueError(f"unknown rng {rng!r}")
    if n_chunks != 1 and rng != "internal":
        raise ValueError("chunked tracing is internal-RNG only")
    cc = camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else scene_table(scene)

    def trace(alb, emi, *args):
        if rng == "internal":
            (seeds,) = args
            kw = dict(seeds=seeds)
        else:
            cam_u, tape = args
            kw = dict(cam_u=cam_u, tape=tape)
        if plain:
            return fused_trace_plain(scene, cc, cfg, alb, emi,
                                     n_chunks=n_chunks, **kw)
        return fused_trace(scene, table, cc, cfg, alb, emi,
                           fastmath=fastmath, n_chunks=n_chunks, **kw)

    return trace
