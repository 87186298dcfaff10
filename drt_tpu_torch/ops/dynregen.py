"""The path-regeneration kernels over memory-resident scenes: two CUDA
kernels and their plain PyTorch versions.

The port of `drt_tpu.ops.dynregen`: the trip loop of `ops.regen` (lanes
are pixels; a dead lane starts its next sample in the same trip) over the
run-time scene of `ops.dynkernel` (the six `DynScene.operands`, up to
`MAX_DYN_SHAPES` shapes, the two-level cull). With n_pix = W*H, C =
n_chunks and t_cap = spp_c * max_depth:
  `make_dyn_regen_tracer`: per-pixel radiance SUMS f32[3, n_pix] over all
    chunks and `trips` i32[C, n_pix];
  `make_dyn_regen_tracer(collect=True)`: the same, and one residual row
    per trip: rsc f32[C, t_cap, n_pix] and rrow i32[C, t_cap, n_pix] =
    albedo row | emission row << 8 | live << 16 | want << 17 | rr_on << 18;
  `make_dyn_regen_sweep_adjoint`: (d_albedo, d_emission) from those rows
    and a per-pixel cotangent; it reads no scene.
The kernels are `csrc/dyn_regen_tracer.cu` and `csrc/dyn_regen_adjoint.cu`
over `csrc/regen_body.cuh` and `csrc/dyn_body.cuh`; the sweep reads each
warp's rows in windows through `csrc/regen_window.cuh`, the window sweep
it shares with `ops.regen`'s, where its ring fits
(`dyn_regen_sweep_form`). Per-pixel `trips`,
unwritten rows beyond them, the chunk dimension, the keyed hash and
`sample_base` are as `ops.regen` says; the limits are the dyn family's
(2048 shapes, 256 rows a table; above `MAX_GRAD_ROWS` real albedo +
emission rows or 32 bounces the sweep takes its deep form, whose
accumulator and rows live in device memory). Sample s of a
pixel is the path of `ops.dynkernel`'s ray slot for that sample, and on a
scene that both families take, of `ops.regen`'s.

`dyn_regen_trace`, `dyn_regen_collect` and `dyn_regen_sweep` are the
wrappers: for tensors on the CPU each runs its plain version; for CUDA
tensors it launches its kernel or raises. Each counts its launches
(`ops.megakernel.launch_counts()`).
"""

from __future__ import annotations

import ctypes

import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.ops.dynkernel import DynScene

SOURCE = "dyn_regen_tracer.cu"
ADJOINT_SOURCE = "dyn_regen_adjoint.cu"
_LIVE_BIT = 2 * dk._ROW_BITS
_WANT_BIT = _LIVE_BIT + 1
_RRON_BIT = _LIVE_BIT + 2


# ---------------------------------------------------------------------------
# The plain PyTorch versions.

def _dyn_regen_plain(ds: DynScene, cc, cfg: RenderConfig, alb, emi, seeds,
                     n_chunks: int, sample_base: int, fastmath: bool,
                     collect: bool, stats: dict | None = None,
                     ray_base: int = 0, n_pix: int | None = None):
    def bounce(state, b, u):
        state, (_, sc, _, ar, er, alive) = dk._dyn_bounce(
            ds, cfg, alb, emi, state, b, u, fastmath=fastmath, stats=stats)
        return state, sc, (ar, er, alive)

    def pack(hit, want, rr_on):
        ar, er, alive = hit
        return (ar + (er << dk._ROW_BITS) + (alive.long() << _LIVE_BIT)
                + (want.long() << _WANT_BIT)
                + (rr_on.long() << _RRON_BIT)).to(torch.int32)

    return rg.trip_loop_plain(cfg, cc, seeds, bounce, pack, n_chunks,
                              sample_base, collect, alb.dtype, alb.device,
                              ray_base, n_pix)


def dyn_regen_trace_plain(ds: DynScene, cc, cfg: RenderConfig,
                          alb: torch.Tensor, emi: torch.Tensor, seeds, *,
                          n_chunks: int = 1, sample_base: int = 0,
                          fastmath: bool = False,
                          stats: dict | None = None, ray_base: int = 0,
                          n_pix: int | None = None):
    """The plain version of the dyn regeneration tracer: (L f[3, n_pix]
    summed over the chunks, trips i32[C, n_pix]) of the n_pix pixels from
    ray_base on (by default all W*H). `fastmath` takes the kernel's fast
    forms except the camera's rsqrt; `stats` gains the counts of
    `ops.dynkernel.dyn_intersect`."""
    return _dyn_regen_plain(ds, cc, cfg, alb, emi, seeds, n_chunks,
                            sample_base, fastmath, False, stats, ray_base,
                            n_pix)


def dyn_regen_collect_plain(ds: DynScene, cc, cfg: RenderConfig,
                            alb: torch.Tensor, emi: torch.Tensor, seeds, *,
                            n_chunks: int = 1, sample_base: int = 0,
                            fastmath: bool = False, ray_base: int = 0,
                            n_pix: int | None = None):
    """The plain version of the collect form: (L, rsc f[C, t_cap, n_pix],
    rrow i32[C, t_cap, n_pix], trips i32[C, n_pix]); rows beyond a
    pixel's trips are zero."""
    return _dyn_regen_plain(ds, cc, cfg, alb, emi, seeds, n_chunks,
                            sample_base, fastmath, True, None, ray_base,
                            n_pix)


def dyn_regen_sweep_plain(cfg: RenderConfig, alb: torch.Tensor,
                          emi: torch.Tensor, rsc: torch.Tensor,
                          rrow: torch.Tensor, trips: torch.Tensor,
                          g: torch.Tensor):
    """The plain version of the dyn regeneration sweep adjoint:
    `ops.regen.sweep_trips_plain` with the rows of each trip unpacked
    from `rrow`."""
    mask = dk._ROW_CAP - 1

    def decode(pack):
        return (((pack >> _LIVE_BIT) & 1) > 0, pack & mask,
                (pack >> dk._ROW_BITS) & mask, ((pack >> _WANT_BIT) & 1) > 0,
                ((pack >> _RRON_BIT) & 1) > 0)

    dead = (alb.shape[0] - 1) | ((emi.shape[0] - 1) << dk._ROW_BITS)
    return rg.sweep_trips_plain(cfg, alb, emi, rsc, rrow, trips, g, decode,
                                dead)


# ---------------------------------------------------------------------------
# The kernels' wrappers.

def _library() -> ctypes.CDLL:
    """The tracer library: drt_dyn_regen_trace, drt_dyn_regen_collect,
    drt_dyn_regen_stats."""
    from drt_tpu_torch.utils import native

    lib = native.load(SOURCE)
    if lib.drt_dyn_regen_trace.argtypes is None:
        structs = (mk._DrtTrace, dk._DynLayout, mk._DrtCamera,
                   dk._DynOperands)
        # alb, emi, sample_base, out, trips, [rsc, rrow | stats,] stream
        mk._bind(lib, "drt_dyn_regen_trace", 6, structs, n_ints_at=(2,))
        mk._bind(lib, "drt_dyn_regen_collect", 8, structs, n_ints_at=(2,))
        mk._bind(lib, "drt_dyn_regen_stats", 7, structs, n_ints_at=(2,))
        lib.drt_dyn_regen_error_string.argtypes = [ctypes.c_int]
        lib.drt_dyn_regen_error_string.restype = ctypes.c_char_p
        mk._check_limits(SOURCE, lib.drt_dyn_regen_limits,
                         [dk._ROW_CAP, rg.N_STATS, mk.BLOCK])
    return lib


def _adjoint_library() -> ctypes.CDLL:
    """The adjoint library: drt_dyn_regen_sweep (and its choice of
    kernel, drt_dyn_regen_sweep_form) and its checking build
    drt_dyn_regen_sweep_lockstep."""
    from drt_tpu_torch.utils import native

    lib = native.load(ADJOINT_SOURCE)
    if lib.drt_dyn_regen_sweep.argtypes is None:
        # alb, emi, rsc, rrow, trips, g, scratch, partials, da, de, stream
        mk._bind(lib, "drt_dyn_regen_sweep", 11, (mk._DrtTrace,))
        mk._bind(lib, "drt_dyn_regen_sweep_lockstep", 11, (mk._DrtTrace,))
        mk._bind_deep_bytes(lib)
        fn = lib.drt_dyn_regen_sweep_form
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.drt_dyn_regen_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.drt_dyn_regen_adjoint_error_string.restype = ctypes.c_char_p
        mk._check_limits(ADJOINT_SOURCE, lib.drt_dyn_regen_adjoint_limits,
                         [dk._ROW_CAP, dk.MAX_GRAD_ROWS, mk.MAX_DEPTH,
                          mk.BLOCK, rg.WINDOW_ROWS, rg.ring_windows(8),
                          rg.ring_windows(mk.MAX_DEPTH)])
    return lib


def _launch_tracer(wrapper, what: str, entry_name: str, ds: DynScene, cc,
                   cfg: RenderConfig, alb, emi, seeds, fastmath: bool,
                   n_chunks: int, sample_base: int, buffers,
                   ray_base: int = 0, n_pix: int | None = None) -> None:
    """Launch one of the tracer library's forms into `buffers` (out,
    trips and, for the collect form, rsc and rrow; for the checking
    build, stats) and count it on `wrapper` (None: not counted)."""
    dev = alb.device
    tcfg = rg.per_pixel(dk._dyn_config(cfg, ds.n_shapes, alb, emi,
                                       seeds=seeds, fastmath=fastmath,
                                       n_chunks=n_chunks), cfg, n_pix,
                        ray_base)
    lay, ops = dk._scene_structs(ds, dev)
    lib = _library()
    mk._launch(wrapper, what, lib.drt_dyn_regen_error_string,
               getattr(lib, entry_name), dev, ctypes.byref(tcfg),
               ctypes.byref(lay), ctypes.byref(mk._camera_struct(cc)),
               ctypes.byref(ops), alb.data_ptr(), emi.data_ptr(),
               sample_base, *(t.data_ptr() for t in buffers))


def dyn_regen_trace(ds: DynScene, cc, cfg: RenderConfig, alb: torch.Tensor,
                    emi: torch.Tensor, seeds, *, fastmath: bool = False,
                    n_chunks: int = 1, sample_base: int = 0,
                    ray_base: int = 0, n_pix: int | None = None):
    """(L f32[3, n_pix] radiance sums, trips i32[C, n_pix]) of the dyn
    regeneration tracer. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise. A shard renders the n_pix pixels from
    ray_base on (by default all W*H from 0)."""
    rg.check_regen_args(cfg, seeds, n_chunks, sample_base)
    if mk._device_of("dyn_regen_trace", alb) == "cpu":
        return dyn_regen_trace_plain(ds, cc, cfg, alb, emi, seeds,
                                     n_chunks=n_chunks,
                                     sample_base=sample_base,
                                     fastmath=fastmath, ray_base=ray_base,
                                     n_pix=n_pix)
    out, trips = rg.trip_buffers(cfg, n_chunks, False, alb.device, n_pix)
    _launch_tracer(dyn_regen_trace, "dyn regeneration tracer",
                   "drt_dyn_regen_trace", ds, cc, cfg, alb, emi, seeds,
                   fastmath, n_chunks, sample_base, (out, trips), ray_base,
                   n_pix)
    return out, trips


def dyn_regen_collect(ds: DynScene, cc, cfg: RenderConfig,
                      alb: torch.Tensor, emi: torch.Tensor, seeds, *,
                      fastmath: bool = False, n_chunks: int = 1,
                      sample_base: int = 0, ray_base: int = 0,
                      n_pix: int | None = None):
    """(L, rsc f32[C, t_cap, n_pix], rrow i32[C, t_cap, n_pix], trips) of
    the collect form. L equals `dyn_regen_trace`'s bit for bit. On the
    card a pixel's rows beyond its trips are uninitialized. CPU tensors
    run the plain version; CUDA tensors launch the kernel or raise.
    ray_base and n_pix as `dyn_regen_trace`'s."""
    rg.check_regen_args(cfg, seeds, n_chunks, sample_base)
    if alb.shape[0] > dk._ROW_CAP or emi.shape[0] > dk._ROW_CAP:
        raise ValueError(
            f"dyn stored residuals pack rows into {dk._ROW_BITS} bits: "
            f"{alb.shape[0]} albedo / {emi.shape[0]} emission rows exceed "
            "that")
    if mk._device_of("dyn_regen_collect", alb) == "cpu":
        return dyn_regen_collect_plain(ds, cc, cfg, alb, emi, seeds,
                                       n_chunks=n_chunks,
                                       sample_base=sample_base,
                                       fastmath=fastmath, ray_base=ray_base,
                                       n_pix=n_pix)
    out, trips, rsc, rrow = rg.trip_buffers(cfg, n_chunks, True, alb.device,
                                            n_pix)
    _launch_tracer(dyn_regen_collect, "dyn regeneration collect tracer",
                   "drt_dyn_regen_collect", ds, cc, cfg, alb, emi, seeds,
                   fastmath, n_chunks, sample_base, (out, trips, rsc, rrow),
                   ray_base, n_pix)
    return out, rsc, rrow, trips


def dyn_regen_trip_stats(ds: DynScene, cc, cfg: RenderConfig,
                         alb: torch.Tensor, emi: torch.Tensor, seeds, *,
                         n_chunks: int = 1) -> dict:
    """Run the tracer's checking build (fast variant) on the card and
    return its counters (`ops.regen.stats_dict`), the cull's among them:
    `group_trips` counts the warp-trips, which equal `warp_trips`. Not
    counted as a launch of the tracer."""
    rg.check_regen_args(cfg, seeds, n_chunks, 0)
    out, trips = rg.trip_buffers(cfg, n_chunks, False, alb.device)
    stats = torch.zeros(rg.N_STATS, dtype=torch.int64, device=alb.device)
    _launch_tracer(None, "dyn regeneration trip-stats", "drt_dyn_regen_stats",
                   ds, cc, cfg, alb, emi, seeds, True, n_chunks, 0,
                   (out, trips, stats))
    return rg.stats_dict(stats, trips, out)


def dyn_regen_sweep_form(cfg: RenderConfig, alb: torch.Tensor,
                         emi: torch.Tensor) -> str:
    """The kernel `dyn_regen_sweep` runs at cfg's depth for tables of
    alb's and emi's rows (the sentinel rows included) on the current
    card: "window" where its ring of rows fits in a block's shared memory
    beside the accumulator and the tables, else "per-pixel"; beyond
    mk.MAX_DEPTH bounces or MAX_GRAD_ROWS real rows "deep", the deep form
    of the per-pixel kernel (csrc/regen_window.cuh)."""
    lib = _adjoint_library()
    window = ctypes.c_int()
    rc = lib.drt_dyn_regen_sweep_form(cfg.max_depth, alb.shape[0],
                                      emi.shape[0], ctypes.byref(window))
    if rc:
        raise RuntimeError("dyn regeneration sweep form query: "
                           + lib.drt_dyn_regen_adjoint_error_string(rc)
                           .decode())
    return rg.SWEEP_FORMS[window.value]


def dyn_regen_sweep(cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                    rsc: torch.Tensor, rrow: torch.Tensor,
                    trips: torch.Tensor, g: torch.Tensor, *,
                    n_chunks: int = 1, build: str = "queue",
                    n_pix: int | None = None):
    """(d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of the dyn
    regeneration sweep adjoint from the collect form's rows and a
    per-pixel cotangent g f32[3, n_pix]. CPU tensors run the plain
    version (`build` selects only the kernel); CUDA tensors launch the
    kernel or raise. The kernel reads each warp's rows in windows of
    adjacent pixels' rows (`dyn_regen_sweep_form`: "window"), or one
    pixel's rows a thread where the windows do not fit; build="lockstep"
    launches the per-pixel kernel at every call, the bit reference, and
    is not counted. A shard's sweep takes its n_pix pixels' rows and
    cotangent, and no pixel offset: it draws nothing."""
    entry = mk._build_entry("drt_dyn_regen_sweep", build)
    if mk._device_of("dyn_regen_sweep", alb) == "cpu":
        return dyn_regen_sweep_plain(cfg, alb, emi, rsc, rrow, trips, g)
    dev = alb.device
    tcfg = rg.per_pixel(dk._dyn_config(cfg, 0, alb, emi, n_chunks=n_chunks),
                        cfg, n_pix)
    rg.check_rows(cfg, n_chunks, rsc, rrow, trips, g, dev, tcfg.n_rays)
    partials, da, de = mk._adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    deep = mk.deep_scratch(lib, tcfg.n_rays, cfg.max_depth, tcfg.n_alb,
                           tcfg.n_emi, dev)
    mk._launch(dyn_regen_sweep if build == "queue" else None,
               "dyn regeneration sweep adjoint",
               lib.drt_dyn_regen_adjoint_error_string, getattr(lib, entry),
               dev, ctypes.byref(tcfg), alb.data_ptr(), emi.data_ptr(),
               rsc.data_ptr(), rrow.data_ptr(), trips.data_ptr(),
               g.data_ptr(), mk._ptr(deep), partials.data_ptr(),
               da.data_ptr(), de.data_ptr())
    return da, de


mk.register_wrappers(dyn_regen_tracer=dyn_regen_trace,
                     dyn_regen_collect=dyn_regen_collect,
                     dyn_regen_sweep=dyn_regen_sweep)


def make_dyn_regen_tracer(scene, cam, cfg: RenderConfig,
                          fastmath: bool = False, collect: bool = False,
                          n_chunks: int = 1, plain: bool = False,
                          n_pix: int | None = None):
    """Build `trace(alb, emi, seeds, sample_base=0) -> (L f32[3, n_pix],
    trips i32[C, n_pix])`, or with collect=True `-> (L, rsc, rrow,
    trips)`, over a Scene or a prebuilt DynScene. plain=True runs the
    plain version on whatever device the tensors lie on (the
    "torch-dyn-regen" backend). n_pix and `trace(..., ray_base=)` select a
    shard's pixels (`ops.regen.make_regen_tracer`)."""
    ds = DynScene.of(scene)
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    if plain:
        fn = dyn_regen_collect_plain if collect else dyn_regen_trace_plain
    else:
        fn = dyn_regen_collect if collect else dyn_regen_trace

    def trace(alb, emi, seeds, sample_base=0, ray_base: int = 0):
        return fn(ds, cc, cfg, alb, emi, seeds, fastmath=fastmath,
                  n_chunks=n_chunks, sample_base=sample_base,
                  ray_base=ray_base, n_pix=n_pix)

    return trace


def make_dyn_regen_sweep_adjoint(scene, cfg: RenderConfig, n_chunks: int = 1,
                                 plain: bool = False, build: str = "queue",
                                 n_pix: int | None = None):
    """Build `sweep(alb, emi, rsc, rrow, trips, g) -> (d_albedo,
    d_emission)` with g f32[3, n_pix] per pixel. `scene` is taken for the
    JAX package's signature; the sweep reads rows, not shapes. `build`
    selects the kernel (`dyn_regen_sweep`)."""
    mk._build_entry("drt_dyn_regen_sweep", build)

    def sweep(alb, emi, rsc, rrow, trips, g):
        if plain:
            return dyn_regen_sweep_plain(cfg, alb, emi, rsc, rrow, trips, g)
        return dyn_regen_sweep(cfg, alb, emi, rsc, rrow, trips, g,
                               n_chunks=n_chunks, build=build, n_pix=n_pix)

    return sweep
