"""The path-regeneration kernels over the scene table: two CUDA kernels
and their plain PyTorch versions.

The port of `drt_tpu.ops.regen`. A lane renders the `spp_c = spp /
spp_chunks` samples of a pixel's chunk one after the other. A trip
is one bounce of every lane at the lane's own depth, and a lane whose path
has died starts its next sample's camera ray in the same trip (`want`)
instead of idling until the deepest path of a lockstep wavefront ends.
With n_pix = W*H, C = n_chunks and t_cap = spp_c * max_depth:
  `make_regen_tracer`: per-pixel radiance SUMS f32[3, n_pix] over all
    chunks (divide by spp for the image) and the trips each pixel ran,
    `trips` i32[C, n_pix];
  `make_regen_tracer(collect=True)`: the same, and one residual row per
    trip: rsc f32[C, t_cap, n_pix] (the sampling weight) and rmeta
    i32[C, t_cap, n_pix] = best | want << 8 | rr_on << 9 (best = hit
    shape + 1, 0 for a trip that ended dead). A trip in which a path dies
    keeps its row (gate 0);
  `make_regen_sweep_adjoint`: (d_albedo f32[K+1, 3], d_emission f32[L+1,
    3]) from those rows and a per-PIXEL cotangent g f32[3, n_pix].
The kernels are `csrc/regen_tracer.cu` and `csrc/regen_adjoint.cu` over
`csrc/regen_body.cuh` and the lockstep kernels' own bounce
(`csrc/fused_body.cuh`); the source notes say what bounds each.

Where this differs from the TPU kernels. There the lanes of a
(tile_rows, 128) tile share one trip counter, finished lanes write dead
rows until the tile is done and `trips` is per tile; `tile_rows`, the
tile-rows choice and the 12 MiB guard of the JAX renderer describe the
TPU's VMEM. Here the unit is the lane: `trips` is per pixel and chunk,
the kernel's lanes take (pixel, chunk) units on a persistent grid as they
free up (csrc/regen_tracer.cu), a pixel's rows beyond its own count are
NEVER written (the buffers come from `torch.empty`) and nothing reads
them, and the factories take no `tile_rows`. The chunk dimension is
always there, also for C == 1. The limits are the fused family's: 64
shapes, 64 table rows, 32 bounces.

Draws are the keyed hash of `ops.rng` over (seed, pixel, sample, bounce,
dim), chunk c starting at sample `sample_base + c * spp_c`: the lockstep
kernels' stream, so sample s of a pixel is the same path in both and its
radiance the same bits. One launch over C chunks equals C launches with
`sample_base = c * spp_c`. The path adds no state of its own:
`scene.from_numpy` and `optim.state_from_numpy` carry everything across.

`regen_trace`, `regen_collect` and `regen_sweep` are the wrappers: for
tensors on the CPU each runs its plain version (the trip loop over all
pixels as tensors, in the JAX kernel's op order); for CUDA tensors it
launches its kernel or raises. Each counts its launches
(`ops.megakernel.launch_counts()`). The sweep reads a warp's rows in
windows of adjacent pixels' rows (`regen_sweep_form`); its
build="lockstep" launches the per-pixel kernel, its checking build and
bit reference, which is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import hash_uniform
from drt_tpu_torch.ops.vecmath import V3
from drt_tpu_torch.renderer import _bounce
from drt_tpu_torch.scene import Scene

SOURCE = "regen_tracer.cu"
ADJOINT_SOURCE = "regen_adjoint.cu"
# Counters of the checking builds (REGEN_N_STATS in csrc/regen_body.cuh):
# the four of the dyn family's cull (the scene-table tracer: the lane-trips
# that ran a bounce, in the first), then lane-trips, the warp-trips that
# ran them, and the same for the trips that ended live.
N_STATS = 8
STAT_NAMES = ("lane_bounces", "warp_bounces", "lane_leaves", "warp_leaves",
              "lane_trips", "group_trips", "live_trips", "live_groups")
# rmeta = best | want << 8 | rr_on << 9.
_WANT_BIT = 8
_RRON_BIT = 9
# The sweep's window kernel (REGEN_WIN and RegenRing in
# csrc/regen_adjoint.cu, checked when the library loads): a warp copies
# its pixels' rows WINDOW_ROWS at a time into a ring of
# `ring_windows(max_depth)` windows.
WINDOW_ROWS = 8


# The kernel of a sweep launch by the code its form query gives.
SWEEP_FORMS = ("per-pixel", "window", "deep")


def ring_windows(max_depth: int) -> int:
    """Windows in the ring of the kernel instance that takes max_depth."""
    return 4 if max_depth <= 8 else 8


def t_cap(cfg: RenderConfig) -> int:
    """Rows a pixel can write per chunk: every sample at full depth."""
    return (cfg.spp // cfg.spp_chunks) * cfg.max_depth


# ---------------------------------------------------------------------------
# The plain PyTorch versions.

def trip_loop_plain(cfg: RenderConfig, cc: mk.CameraConsts, seeds, bounce,
                    pack, n_chunks: int, sample_base: int, collect: bool,
                    dtype, device, ray_base: int = 0,
                    n_pix: int | None = None):
    """The trip loop of both regeneration families over all pixels as
    tensors (regen.py:242-336). `bounce(state, b, u) -> (state, sc, hit)`
    runs one bounce of every lane at its own depth b i64[n] on state =
    (o, d, T f[3, n], L f[3, n], alive), o and d tuples of three f[n];
    `pack(hit, want, rr_on) -> i32[n]` packs the residual row.

    Returns (L f[3, n] summed over the chunks, trips i32[C, n]) and with
    `collect` also (rsc, rcode), each [C, t_cap, n] with zeros beyond a
    pixel's own trips, for the n = n_pix pixels from ray_base on (by
    default all W*H from 0)."""
    npix = cfg.width * cfg.height if n_pix is None else n_pix
    spp_c = cfg.spp // cfg.spp_chunks
    cap = t_cap(cfg)
    seed_cam, seed_bnc = (int(v) for v in seeds)
    pix = torch.arange(ray_base, ray_base + npix, dtype=torch.int64,
                       device=device)
    L_all = None
    trips_all, rsc_all, rcode_all = [], [], []
    for c in range(n_chunks):
        sbase = sample_base + c * spp_c
        zero = torch.zeros(npix, dtype=dtype, device=device)
        o = d = (zero, zero, zero)
        T = torch.zeros((3, npix), dtype=dtype, device=device)
        L = torch.zeros((3, npix), dtype=dtype, device=device)
        alive = torch.zeros(npix, dtype=torch.bool, device=device)
        s = torch.full((npix,), -1, dtype=torch.int64, device=device)
        b = torch.zeros(npix, dtype=torch.int64, device=device)
        trips = torch.zeros(npix, dtype=torch.int32, device=device)
        if collect:
            rsc = torch.zeros((cap, npix), dtype=dtype, device=device)
            rcode = torch.zeros((cap, npix), dtype=torch.int32,
                                device=device)
        for trip in range(cap):
            active = alive | (s < spp_c - 1)
            if not bool(active.any()):
                break
            trips += active
            # Dead lanes with samples left start the next sample's camera
            # ray in this same trip.
            want = ~alive & (s < spp_c - 1)
            s = torch.where(want, s + 1, s)
            sg = s + sbase
            u_s = hash_uniform(seed_cam, pix, sg, 0, 0, dtype, device)
            u_t = hash_uniform(seed_cam, pix, sg, 0, 1, dtype, device)
            o_n, d_n = mk.camera_ray_from_pix(cc, pix, u_s, u_t)
            o = tuple(torch.where(want, n_, o_) for n_, o_ in zip(o_n, o))
            d = tuple(torch.where(want, n_, d_) for n_, d_ in zip(d_n, d))
            T = torch.where(want, 1.0, T)
            b = torch.where(want, 0, b)
            alive = alive | want

            # One bounce at the lane's own depth.
            u = tuple(hash_uniform(seed_bnc, pix, sg, b, dim, dtype, device)
                      for dim in (0, 1, 2))
            (o, d, T, L, alive), sc, hit = bounce((o, d, T, L, alive), b, u)
            if collect:
                code = pack(hit, want, b >= cfg.min_bounces)
                rsc[trip] = torch.where(active, sc, 0.0)
                rcode[trip] = torch.where(active, code, 0)
            b = b + 1
            # The static depth bound, per lane.
            alive = alive & (b < cfg.max_depth)
        L_all = L if L_all is None else L_all + L
        trips_all.append(trips)
        if collect:
            rsc_all.append(rsc)
            rcode_all.append(rcode)
    if not collect:
        return L_all, torch.stack(trips_all)
    return (L_all, torch.stack(rsc_all), torch.stack(rcode_all),
            torch.stack(trips_all))


def _regen_plain(scene: Scene, cc: mk.CameraConsts, cfg: RenderConfig, alb,
                 emi, seeds, n_chunks: int, sample_base: int, collect: bool,
                 ray_base: int = 0, n_pix: int | None = None):
    tabs = (alb, emi)

    def bounce(state, b, u):
        o, d, T, L, alive = state
        (o, d, T, L, alive), (_, sc, _, _, _), hit = _bounce(
            tabs, scene, cfg, (V3(*o), V3(*d), V3(*T), V3(*L), alive), b, u)
        best = torch.where(alive, hit.shape + 1, 0)
        return ((tuple(o), tuple(d), torch.stack(T), torch.stack(L), alive),
                sc, best)

    def pack(best, want, rr_on):
        return (best | (want.long() << _WANT_BIT)
                | (rr_on.long() << _RRON_BIT)).to(torch.int32)

    return trip_loop_plain(cfg, cc, seeds, bounce, pack, n_chunks,
                           sample_base, collect, alb.dtype, alb.device,
                           ray_base, n_pix)


def regen_trace_plain(scene: Scene, cc: mk.CameraConsts, cfg: RenderConfig,
                      alb: torch.Tensor, emi: torch.Tensor, seeds, *,
                      n_chunks: int = 1, sample_base: int = 0,
                      ray_base: int = 0, n_pix: int | None = None):
    """The plain version of the regeneration tracer: (L f[3, n_pix] summed
    over the chunks, trips i32[C, n_pix]) of the n_pix pixels from
    ray_base on (by default all W*H from 0)."""
    return _regen_plain(scene, cc, cfg, alb, emi, seeds, n_chunks,
                        sample_base, False, ray_base, n_pix)


def regen_collect_plain(scene: Scene, cc: mk.CameraConsts, cfg: RenderConfig,
                        alb: torch.Tensor, emi: torch.Tensor, seeds, *,
                        n_chunks: int = 1, sample_base: int = 0,
                        ray_base: int = 0, n_pix: int | None = None):
    """The plain version of the collect form: (L, rsc f[C, t_cap, n_pix],
    rmeta i32[C, t_cap, n_pix], trips i32[C, n_pix]); rows beyond a
    pixel's trips are zero."""
    return _regen_plain(scene, cc, cfg, alb, emi, seeds, n_chunks,
                        sample_base, True, ray_base, n_pix)


def sweep_trips_plain(cfg: RenderConfig, alb: torch.Tensor,
                      emi: torch.Tensor, rsc: torch.Tensor,
                      rcode: torch.Tensor, trips: torch.Tensor,
                      g: torch.Tensor, decode, dead_code: int):
    """Replay and reverse sweep over the rows of the collect form, shared
    by both families (regen.py:483-556): `decode(code i64[n]) -> (live,
    albedo row, emission row, want, rr_on)`, and `dead_code` stands for
    every row beyond a pixel's own trips, which are not read. Pass 1
    replays `T := 1` at want rows, `gate = rr [live]`, `P = T gate`, `T =
    (P a) sc`; pass 2 walks the trips in reverse with `S := 0` where it
    crosses a want row. Returns (d_albedo f[K+1, 3], d_emission f[L+1,
    3]), sentinel rows zero."""
    n_chunks, _, n = rsc.shape
    dtype, dev = alb.dtype, alb.device
    n_alb, n_emi = alb.shape[0], emi.shape[0]
    # The roulette scale rounded to dtype once (a Python float in
    # torch.where would make a float32 tensor).
    keep = torch.tensor(1.0 / (1.0 - cfg.absorb_prob), dtype=dtype,
                        device=dev)
    da = torch.zeros((n_alb, 3), dtype=dtype, device=dev)
    de = torch.zeros((n_emi, 3), dtype=dtype, device=dev)

    def add_rows(acc, rows, v, n_rows):
        for k in range(n_rows - 1):  # the sentinel row stays zero
            acc[k] += torch.where(rows == k, v, 0.0).sum(dim=1)

    for c in range(n_chunks):
        T = torch.zeros((3, n), dtype=dtype, device=dev)
        steps = []
        for t in range(int(trips[c].max())):
            own = t < trips[c]
            sc = torch.where(own, rsc[c, t], 0.0)
            live, arow, erow, want, rr_on = decode(
                torch.where(own, rcode[c, t].long(), dead_code))
            T = torch.where(want, 1.0, T)
            gate = torch.where(live, torch.where(rr_on, keep, 1.0), 0.0)
            P = T * gate
            a = alb[arow].T
            T = P * a * sc
            steps.append((P, sc, gate, arow, erow, a, want))
        S = torch.zeros((3, n), dtype=dtype, device=dev)
        for P, sc, gate, arow, erow, a, want in reversed(steps):
            gP = g * P
            add_rows(de, erow, gP, n_emi)
            add_rows(da, arow, gP * sc * S, n_alb)
            S = (emi[erow].T + a * sc * S) * gate
            # Below a sample's start lies the previous sample's last trip.
            S = torch.where(want, 0.0, S)
    return da, de


def regen_sweep_plain(scene: Scene, cfg: RenderConfig, alb: torch.Tensor,
                      emi: torch.Tensor, rsc: torch.Tensor,
                      rmeta: torch.Tensor, trips: torch.Tensor,
                      g: torch.Tensor):
    """The plain version of the regeneration sweep adjoint:
    `sweep_trips_plain` with the rows of each trip looked up from the hit
    shape in `rmeta`."""
    dev = alb.device
    # Row of each table by best (0 = dead -> the sentinel rows).
    arow_of = torch.tensor(
        [alb.shape[0] - 1]
        + scene.mat_albedo[scene.shape_mat.long()].tolist(), device=dev)
    erow_of = torch.tensor([emi.shape[0] - 1] + scene.shape_emit.tolist(),
                           device=dev)

    def decode(meta):
        best = meta & 0xFF
        return (best > 0, arow_of[best], erow_of[best],
                ((meta >> _WANT_BIT) & 1) > 0, ((meta >> _RRON_BIT) & 1) > 0)

    return sweep_trips_plain(cfg, alb, emi, rsc, rmeta, trips, g, decode, 0)


def rows_by_sample(cfg: RenderConfig, rsc: torch.Tensor,
                   rcode: torch.Tensor, trips: torch.Tensor, want_bit: int,
                   keep: int, dead_code: int):
    """The rows of a collect form laid out as a lockstep collect tracer
    lays them: (sc f[C, D, spp_c * n], code i32[C, D, spp_c * n]), slot
    i of chunk c being pixel i % n at sample i // n of the chunk, row d
    its bounce d. A sample's rows are those from a want row up to the
    next; the slots it did not reach hold (0, dead_code), as a lockstep
    lane holds them after its path died. `code` keeps the bits `keep` of
    the stored row. For checks: sample for sample these are the lockstep
    residuals of the same seeds."""
    n_chunks, cap, n = rsc.shape
    spp_c = cfg.spp // cfg.spp_chunks
    D = cfg.max_depth
    dev = rsc.device
    t = torch.arange(cap, device=dev)[:, None]
    pix = torch.arange(n, device=dev)[None, :]
    sc_out = torch.zeros((n_chunks, D, spp_c * n), dtype=rsc.dtype,
                         device=dev)
    code_out = torch.full((n_chunks, D, spp_c * n), dead_code,
                          dtype=torch.int32, device=dev)
    for c in range(n_chunks):  # chunk by chunk: the index tensors are i64
        own = t < trips[c][None, :]
        want = (((rcode[c] >> want_bit) & 1) > 0) & own
        sample = want.cumsum(dim=0) - 1
        start = torch.where(want, t, 0).cummax(dim=0).values
        slot = ((t - start) * (spp_c * n) + sample * n + pix)[own]
        sc_out[c].view(-1)[slot] = rsc[c][own]
        code_out[c].view(-1)[slot] = rcode[c][own] & keep
    return sc_out, code_out


# ---------------------------------------------------------------------------
# The kernels' wrappers.

def _library() -> ctypes.CDLL:
    """The tracer library: drt_regen_trace, drt_regen_collect, the
    checking build drt_regen_stats and the grid query drt_regen_grid."""
    from drt_tpu_torch.utils import native

    lib = native.load(SOURCE)
    if lib.drt_regen_trace.argtypes is None:
        both = (mk._DrtTrace, mk._DrtCamera)
        # scene, alb, emi, sample_base, out, trips, [rsc, rmeta,] scratch,
        # [stats,] stream
        mk._bind(lib, "drt_regen_trace", 8, both, n_ints_at=(3,))
        mk._bind(lib, "drt_regen_collect", 10, both, n_ints_at=(3,))
        mk._bind(lib, "drt_regen_stats", 9, both, n_ints_at=(3,))
        lib.drt_regen_grid.argtypes = ([ctypes.c_int] * 4
                                       + [ctypes.POINTER(ctypes.c_int)] * 2)
        lib.drt_regen_grid.restype = ctypes.c_int
        lib.drt_regen_error_string.argtypes = [ctypes.c_int]
        lib.drt_regen_error_string.restype = ctypes.c_char_p
        mk._check_limits(SOURCE, lib.drt_regen_limits,
                         [mk.MAX_SHAPES, mk.MAX_ROWS, mk.REC, N_STATS,
                          mk.BLOCK])
    return lib


def _adjoint_library() -> ctypes.CDLL:
    """The adjoint library: drt_regen_sweep (and its choice of kernel,
    drt_regen_sweep_form) and its checking build drt_regen_sweep_lockstep."""
    from drt_tpu_torch.utils import native

    lib = native.load(ADJOINT_SOURCE)
    if lib.drt_regen_sweep.argtypes is None:
        # scene, alb, emi, rsc, rmeta, trips, g, scratch, partials, da, de,
        # stream
        mk._bind(lib, "drt_regen_sweep", 12, (mk._DrtTrace,))
        mk._bind(lib, "drt_regen_sweep_lockstep", 12, (mk._DrtTrace,))
        mk._bind_deep_bytes(lib)
        fn = lib.drt_regen_sweep_form
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        lib.drt_regen_adjoint_error_string.argtypes = [ctypes.c_int]
        lib.drt_regen_adjoint_error_string.restype = ctypes.c_char_p
        mk._check_limits(ADJOINT_SOURCE, lib.drt_regen_adjoint_limits,
                         [mk.MAX_SHAPES, mk.MAX_ROWS, mk.REC, mk.MAX_DEPTH,
                          mk.BLOCK, WINDOW_ROWS, ring_windows(8),
                          ring_windows(mk.MAX_DEPTH)])
    return lib


def check_regen_args(cfg: RenderConfig, seeds, n_chunks: int,
                     sample_base: int) -> None:
    """What both families' tracers refuse before a launch."""
    if seeds is None:
        raise ValueError("the regeneration kernels draw from the keyed hash "
                         "only: pass seeds (camera, bounce)")
    if sample_base < 0 or (sample_base
                           + n_chunks * (cfg.spp // cfg.spp_chunks)
                           >= 2 ** 31):
        raise ValueError(f"sample_base {sample_base}: sample indices must "
                         "stay within 31 bits")


def per_pixel(tcfg: mk._DrtTrace, cfg: RenderConfig,
              n_pix: int | None = None, ray_base: int = 0) -> mk._DrtTrace:
    """A kernel config whose slots are pixels: one thread per pixel, the
    n_pix pixels from ray_base on (a shard's; by default all W*H)."""
    npix = cfg.width * cfg.height
    tcfg.n_rays = npix if n_pix is None else n_pix
    if ray_base:
        mk.check_ray_base(ray_base, tcfg.n_rays, npix)
    tcfg.ray_base = ray_base
    return tcfg


def trip_buffers(cfg: RenderConfig, n_chunks: int, collect: bool, dev,
                 n_pix: int | None = None):
    """(out, trips) and, with `collect`, (rsc, rcode): uninitialized, a
    pixel's rows beyond its trips stay so."""
    npix = cfg.width * cfg.height if n_pix is None else n_pix
    out = torch.empty((3, npix), dtype=torch.float32, device=dev)
    trips = torch.empty((n_chunks, npix), dtype=torch.int32, device=dev)
    if not collect:
        return out, trips
    shape = (n_chunks, t_cap(cfg), npix)
    return (out, trips, torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _scratch(n_pix: int, n_chunks: int, dev) -> torch.Tensor:
    """The tracer's scratch: its batch counter (16 bytes) and, over more
    than one chunk, the radiance of each (pixel, chunk) unit f32[C, 3,
    n_pix] after it."""
    sums = 3 * n_chunks * n_pix if n_chunks > 1 else 0
    return torch.empty(4 + sums, dtype=torch.float32, device=dev)


def check_rows(cfg: RenderConfig, n_chunks: int, rsc, rcode, trips, g,
               dev, n_pix: int | None = None) -> None:
    """Shapes and types of what a sweep kernel reads."""
    npix = cfg.width * cfg.height if n_pix is None else n_pix
    shape = (n_chunks, t_cap(cfg), npix)
    mk._check("rsc", rsc, shape, dev)
    mk._check("residual rows", rcode, shape, dev, torch.int32)
    mk._check("trips", trips, (n_chunks, npix), dev, torch.int32)
    mk._check("g", g, (3, npix), dev)


def stats_dict(stats: torch.Tensor, trips: torch.Tensor, out) -> dict:
    """A checking build's counters by name, with what `trips` says and the
    radiance. `warp_trips` is the least number of trips the warps of a
    grid of one thread per pixel must run (the memory-resident tracer's:
    a warp of 32 consecutive pixels runs until the pixel with the most
    trips over all chunks is done, since a lane goes on to its next chunk
    without waiting for its warp), and its checking build's `group_trips`
    equal it; `warp_trips_by_chunk` is what they would run if they did
    wait. The scene-table tracer hands its units out to lanes as they free
    up and writes a dying trip's row without a bounce: its `group_trips`
    (warp-trips that ran a bounce) hold its `lane_bounces` (the lane-trips
    that ran one), at most 32 each, and `lane_trips` counts every trip."""
    d = dict(zip(STAT_NAMES, stats.tolist()))
    n_chunks, npix = trips.shape
    per_warp = torch.nn.functional.pad(trips, (0, -npix % 32)).reshape(
        n_chunks, -1, 32)
    d.update(trips_sum=int(trips.sum().item()),
             trips_max=int(trips.max().item()),
             warp_trips=int(per_warp.sum(dim=0).amax(dim=1).sum().item()),
             warp_trips_by_chunk=int(per_warp.amax(dim=2).sum().item()),
             radiance=out)
    return d


def _launch_tracer(wrapper, what: str, entry_name: str,
                   table: torch.Tensor, cc: mk.CameraConsts,
                   cfg: RenderConfig, alb, emi, seeds, fastmath: bool,
                   n_chunks: int, sample_base: int, buffers,
                   stats=None, ray_base: int = 0,
                   n_pix: int | None = None) -> None:
    """Launch one of the tracer library's forms into `buffers` (out, trips
    and, for the collect form, rsc and rmeta), with its scratch and, for
    the checking build, stats; count it on `wrapper` (None: not
    counted)."""
    dev = alb.device
    tcfg = per_pixel(mk._trace_config(cfg, table, alb, emi, seeds=seeds,
                                      fastmath=fastmath, n_chunks=n_chunks),
                     cfg, n_pix, ray_base)
    scratch = _scratch(tcfg.n_rays, n_chunks, dev)
    lib = _library()
    mk._launch(wrapper, what, lib.drt_regen_error_string,
               getattr(lib, entry_name), dev, ctypes.byref(tcfg),
               ctypes.byref(mk._camera_struct(cc)), table.data_ptr(),
               alb.data_ptr(), emi.data_ptr(), sample_base,
               *(t.data_ptr() for t in buffers), scratch.data_ptr(),
               *(() if stats is None else (stats.data_ptr(),)))


def regen_trace(scene: Scene, table: torch.Tensor, cc: mk.CameraConsts,
                cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                seeds, *, fastmath: bool = False, n_chunks: int = 1,
                sample_base: int = 0, ray_base: int = 0,
                n_pix: int | None = None):
    """(L f32[3, n_pix] radiance sums, trips i32[C, n_pix]) of the
    regeneration tracer. CPU tensors run the plain version (which has one
    form, so `fastmath` selects only the kernel's variant); CUDA tensors
    launch the kernel or raise. A shard renders the n_pix pixels from
    ray_base on (by default all W*H from 0)."""
    check_regen_args(cfg, seeds, n_chunks, sample_base)
    if mk._device_of("regen_trace", alb) == "cpu":
        return regen_trace_plain(scene, cc, cfg, alb, emi, seeds,
                                 n_chunks=n_chunks, sample_base=sample_base,
                                 ray_base=ray_base, n_pix=n_pix)
    out, trips = trip_buffers(cfg, n_chunks, False, alb.device, n_pix)
    _launch_tracer(regen_trace, "regeneration tracer", "drt_regen_trace",
                   table, cc, cfg, alb, emi, seeds, fastmath, n_chunks,
                   sample_base, (out, trips), None, ray_base, n_pix)
    return out, trips


def regen_collect(scene: Scene, table: torch.Tensor, cc: mk.CameraConsts,
                  cfg: RenderConfig, alb: torch.Tensor, emi: torch.Tensor,
                  seeds, *, fastmath: bool = False, n_chunks: int = 1,
                  sample_base: int = 0, ray_base: int = 0,
                  n_pix: int | None = None):
    """(L, rsc f32[C, t_cap, n_pix], rmeta i32[C, t_cap, n_pix], trips) of
    the collect form. L equals `regen_trace`'s bit for bit. On the card a
    pixel's rows beyond its trips are uninitialized. CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise. ray_base and
    n_pix as `regen_trace`'s."""
    check_regen_args(cfg, seeds, n_chunks, sample_base)
    if mk._device_of("regen_collect", alb) == "cpu":
        return regen_collect_plain(scene, cc, cfg, alb, emi, seeds,
                                   n_chunks=n_chunks,
                                   sample_base=sample_base,
                                   ray_base=ray_base, n_pix=n_pix)
    out, trips, rsc, rmeta = trip_buffers(cfg, n_chunks, True, alb.device,
                                          n_pix)
    _launch_tracer(regen_collect, "regeneration collect tracer",
                   "drt_regen_collect", table, cc, cfg, alb, emi, seeds,
                   fastmath, n_chunks, sample_base, (out, trips, rsc, rmeta),
                   None, ray_base, n_pix)
    return out, rsc, rmeta, trips


def regen_trip_stats(scene: Scene, table: torch.Tensor, cc: mk.CameraConsts,
                     cfg: RenderConfig, alb: torch.Tensor,
                     emi: torch.Tensor, seeds, *,
                     n_chunks: int = 1) -> dict:
    """Run the tracer's checking build (fast variant) on the card and
    return its counters (`stats_dict`) and the clock64() cycles of each
    section of its warp-trips by name (`cycles`, `megakernel.SECTIONS`,
    timed by the first active lane of the warp). Not counted as a launch
    of the tracer."""
    check_regen_args(cfg, seeds, n_chunks, 0)
    out, trips = trip_buffers(cfg, n_chunks, False, alb.device)
    stats = torch.zeros(N_STATS + mk.N_SECT, dtype=torch.int64,
                        device=alb.device)
    _launch_tracer(None, "regeneration trip-stats", "drt_regen_stats", table,
                   cc, cfg, alb, emi, seeds, True, n_chunks, 0,
                   (out, trips), stats)
    d = stats_dict(stats[:N_STATS], trips, out)
    d["cycles"] = dict(zip(mk.SECTIONS, stats[N_STATS:].tolist()))
    return d


def regen_grid(cfg: RenderConfig, *, n_chunks: int = 1, collect: bool = False,
               fastmath: bool = True) -> dict:
    """The tracer's persistent grid on this card: the blocks an SM holds
    (the occupancy API), the SMs, the blocks launched and the lanes they
    hold (at most a lane per (pixel, chunk) unit)."""
    lib = _library()
    per_sm, grid = ctypes.c_int(), ctypes.c_int()
    rc = lib.drt_regen_grid(int(fastmath), int(collect),
                            cfg.width * cfg.height, n_chunks,
                            ctypes.byref(per_sm), ctypes.byref(grid))
    if rc:
        raise RuntimeError("regeneration grid query: "
                           + lib.drt_regen_error_string(rc).decode())
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    return dict(blocks_per_sm=per_sm.value, sms=sms, grid=grid.value,
                lanes=grid.value * mk.BLOCK)


def regen_sweep_form(cfg: RenderConfig, alb: torch.Tensor,
                     emi: torch.Tensor) -> str:
    """The kernel `regen_sweep` runs at cfg's depth for tables of alb's
    and emi's rows (the sentinel rows included) on the current card:
    "window" where its ring of rows fits in a block's shared memory beside
    the accumulator, else "per-pixel"; beyond mk.MAX_DEPTH bounces "deep",
    the deep form of the per-pixel kernel (csrc/regen_window.cuh)."""
    window = ctypes.c_int()
    rc = _adjoint_library().drt_regen_sweep_form(
        cfg.max_depth, alb.shape[0], emi.shape[0], ctypes.byref(window))
    if rc:
        raise RuntimeError("regeneration sweep form query: "
                           + _adjoint_library()
                           .drt_regen_adjoint_error_string(rc).decode())
    return SWEEP_FORMS[window.value]


def regen_sweep(scene: Scene, table: torch.Tensor, cfg: RenderConfig,
                alb: torch.Tensor, emi: torch.Tensor, rsc: torch.Tensor,
                rmeta: torch.Tensor, trips: torch.Tensor, g: torch.Tensor,
                *, n_chunks: int = 1, build: str = "queue",
                n_pix: int | None = None):
    """(d_albedo f32[K+1, 3], d_emission f32[L+1, 3]) of the regeneration
    sweep adjoint from the collect form's rows and a per-pixel cotangent
    g f32[3, n_pix]. CPU tensors run the plain version (`build` selects
    only the kernel); CUDA tensors launch the kernel or raise. The kernel
    reads each warp's rows in windows of adjacent pixels' rows
    (`regen_sweep_form`: "window"), or one pixel's rows a thread where the
    windows do not fit; build="lockstep" launches the per-pixel kernel at
    every call, the bit reference, and is not counted. A shard's sweep
    takes its n_pix pixels' rows and cotangent, and no pixel offset: it
    draws nothing."""
    entry = mk._build_entry("drt_regen_sweep", build)
    if mk._device_of("regen_sweep", alb) == "cpu":
        return regen_sweep_plain(scene, cfg, alb, emi, rsc, rmeta, trips, g)
    dev = alb.device
    tcfg = per_pixel(mk._trace_config(cfg, table, alb, emi,
                                      n_chunks=n_chunks), cfg, n_pix)
    check_rows(cfg, n_chunks, rsc, rmeta, trips, g, dev, tcfg.n_rays)
    partials, da, de = mk._adjoint_buffers(cfg, tcfg, g, dev)
    lib = _adjoint_library()
    deep = mk.deep_scratch(lib, tcfg.n_rays, cfg.max_depth, tcfg.n_alb,
                           tcfg.n_emi, dev)
    mk._launch(regen_sweep if build == "queue" else None,
               "regeneration sweep adjoint",
               lib.drt_regen_adjoint_error_string, getattr(lib, entry), dev,
               ctypes.byref(tcfg), table.data_ptr(), alb.data_ptr(),
               emi.data_ptr(), rsc.data_ptr(), rmeta.data_ptr(),
               trips.data_ptr(), g.data_ptr(), mk._ptr(deep),
               partials.data_ptr(), da.data_ptr(), de.data_ptr())
    return da, de


mk.register_wrappers(regen_tracer=regen_trace, regen_collect=regen_collect,
                     regen_sweep=regen_sweep)


def make_regen_tracer(scene: Scene, cam, cfg: RenderConfig,
                      fastmath: bool = False, collect: bool = False,
                      n_chunks: int = 1, plain: bool = False,
                      n_pix: int | None = None):
    """Build `trace(alb, emi, seeds, sample_base=0) -> (L f32[3, n_pix],
    trips i32[C, n_pix])`, or with collect=True `-> (L, rsc, rmeta,
    trips)`. L holds per-pixel radiance SUMS over all n_chunks * spp_c
    samples from `sample_base` on. plain=True runs the plain version on
    whatever device the tensors lie on (the "torch-regen" backend).
    n_pix (by default W*H) is a shard's count of pixels, and `trace(...,
    ray_base=k * n_pix)` renders shard k's."""
    cc = mk.camera_consts(cam, cfg.width, cfg.height)
    table = None if plain else mk.scene_table(scene)

    def trace(alb, emi, seeds, sample_base=0, ray_base: int = 0):
        kw = dict(n_chunks=n_chunks, sample_base=sample_base,
                  ray_base=ray_base, n_pix=n_pix)
        if plain:
            fn = regen_collect_plain if collect else regen_trace_plain
            return fn(scene, cc, cfg, alb, emi, seeds, **kw)
        fn = regen_collect if collect else regen_trace
        return fn(scene, table, cc, cfg, alb, emi, seeds, fastmath=fastmath,
                  **kw)

    return trace


def make_regen_sweep_adjoint(scene: Scene, cfg: RenderConfig,
                             n_chunks: int = 1, plain: bool = False,
                             build: str = "queue", n_pix: int | None = None):
    """Build `sweep(alb, emi, rsc, rmeta, trips, g) -> (d_albedo,
    d_emission)`: the backward from the collect form's rows, with g
    f32[3, n_pix] per pixel, the same for all of a pixel's samples.
    `build` selects the kernel (`regen_sweep`)."""
    mk._build_entry("drt_regen_sweep", build)
    table = None if plain else mk.scene_table(scene)

    def sweep(alb, emi, rsc, rmeta, trips, g):
        if plain:
            return regen_sweep_plain(scene, cfg, alb, emi, rsc, rmeta, trips,
                                     g)
        return regen_sweep(scene, table, cfg, alb, emi, rsc, rmeta, trips, g,
                           n_chunks=n_chunks, build=build, n_pix=n_pix)

    return sweep
