"""The plain versions of the adjoint kernels beyond the card's in-thread
limits, against the JAX package's pure-array tape forms in float64 to
rtol 1e-10: paths of 40 bounces (the card's kernels keep 32 rows a path
in the thread and the rest, in their deep forms, in device memory) and
memory-resident scenes of more than 144 real albedo + emission rows (the
rows whose gradient accumulator a block's shared memory holds), up to the
255 + 255 that 8-bit row packing allows. The scene-table family's checks
take every albedo 0.8, so that the rows past 32 weigh (`BRIGHT`); the
memory-resident family's scenes (DynScene) are float32 only, so its
plain versions are held to the float64 reference at rtol 1e-4 / atol
1e-5 on the scenes' own albedos, and its plain sweep B8, which reads no
scene, also in float64 on the JAX tape form's own bright rows.

Every form draws from the same keyed-hash tapes (drt_tpu.ops.regen.
hash_tapes, the lockstep order): the tape forms of the fused family (the
sweep B3 on the collect tracer's rows, the retrace adjoint B4, the
wavefront adjoint B5b) and of the memory-resident family (B8, B9), and the
path-regeneration sweeps (B11, B13), whose samples are those of the
lockstep slots. The reference is drt_tpu.adjoint.make_diff_renderer(
use_tape=True) under jax.grad (on the wide scenes the JAX tape form's
residuals with _param_grads' sweep in numpy, which one test holds to
jax.grad on a wide scene small enough to compile), built once per scene.
absorb_prob 0.05 keeps paths alive past bounce 32, which each test
asserts (at the default 0.5 a path reaches bounce 33 with probability
2e-10). The kernels themselves are held to these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from drt_tpu.adjoint import make_diff_renderer as jax_make_diff_renderer
from drt_tpu.camera import look_at as jax_look_at
from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops.regen import hash_tapes as jax_hash_tapes
from drt_tpu.ops.vecmath import V3 as JV3
from drt_tpu.renderer import trace_rays as jax_trace_rays
from drt_tpu.scene import SceneBuilder as JaxSceneBuilder
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import dynkernel as dk
from drt_tpu_torch.ops import dynregen as dr
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops import regen as rg
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

TOL = dict(rtol=1e-10, atol=1e-12)
# The memory-resident family is float32 only: its plain versions against
# the float64 reference, the tolerance of tests/test_torch_dynkernel.py's
# gradients against XLA.
F32_TOL = dict(rtol=1e-4, atol=1e-5)
CFG = RenderConfig(width=8, height=6, spp=2, max_depth=40,
                   absorb_prob=0.05)
NPIX = CFG.width * CFG.height
N = NPIX * CFG.spp
SEEDS = (20251, -3)


def wide_scene(builder, n_alb: int, n_emi: int, n_tri: int = 24):
    """The Cornell box's six walls (white) around a grid of n_tri
    triangles in front of the back wall, each diffuse and emitting: a
    scene of n_alb + n_emi real table rows, of which the triangles use
    rows spread from the first to the last of each table (row 0 of the
    albedo table also the walls'). The triangles share no edge (a ray
    through a shared edge hits either by an ulp). Few shapes keep the JAX
    side's compile short; the kernels' accumulator holds every row all
    the same."""
    alb = [builder.albedo_param([0.3 + 0.4 * ((k * 37) % 11) / 10,
                                 0.3 + 0.4 * ((k * 53) % 7) / 6,
                                 0.3 + 0.4 * ((k * 71) % 5) / 4])
           for k in range(n_alb)]
    emi = [builder.emission_param([0.05 + 0.01 * (k % 7), 0.05,
                                   0.05 + 0.01 * (k % 3)])
           for k in range(n_emi)]
    walls = builder.diffuse(alb[0])
    for n, off in (([-1.0, 0.0, 0.0], -3.0), ([1.0, 0.0, 0.0], -3.0),
                   ([0.0, 0.0, -1.0], -6.0), ([0.0, 0.0, 1.0], 0.0),
                   ([0.0, 1.0, 0.0], -3.0), ([0.0, -1.0, 0.0], -3.0)):
        builder.plane(n, off, walls)
    side = int(np.ceil(np.sqrt(n_tri / 2)))
    step = 5.0 / side
    for k in range(n_tri):
        cell, upper = divmod(k, 2)
        x0 = -2.5 + step * (cell % side)
        y0 = -2.5 + step * (cell // side)
        z = 5.0 - 0.5 * ((cell * 7) % 3)
        a, b = 0.1 * step, 0.8 * step  # a gap around each triangle
        v = ([x0 + a, y0, z], [x0 + b, y0, z], [x0 + a, y0 + b - a, z]) \
            if not upper else ([x0 + step, y0 + a, z],
                               [x0 + step, y0 + b, z],
                               [x0 + step - b + a, y0 + b, z])
        builder.triangle(*v,
                         builder.diffuse(alb[k * (n_alb - 1) // (n_tri - 1)]),
                         emi[k * (n_emi - 1) // (n_tri - 1)])
    return builder


def _wide_jax(n_alb, n_emi, n_tri=24):
    js, jp = wide_scene(JaxSceneBuilder(), n_alb, n_emi, n_tri).build(
        dtype=jnp.float64)
    return js, jp, jax_look_at(jnp.zeros(3), jnp.array([0.0, 0.0, 1.0]),
                               dtype=jnp.float64)


SCENES = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy,
          "wide10": functools.partial(_wide_jax, 6, 4, 4),
          "wide150": functools.partial(_wide_jax, 100, 50),
          "wide255": functools.partial(_wide_jax, 255, 255)}
# The albedo of every row in the float64 checks of the scene-table family:
# a path keeps 0.8 / (1 - 0.05) of its throughput a bounce, so its rows
# past 32 weigh 4e-3 of its first in the gradients (at the scenes' own
# 0.5, 1e-8). The float32 checks of the memory-resident family keep the
# scenes' albedos: over 40 bright bounces the ulps of float32 turn paths
# (on the glossy scene the scene-table family's float32 plain version
# parts from the float64 reference by 3%, as the memory-resident one
# does), so there the rows past 32 are checked on the card, float32
# against float32 (tests/test_torch_cuda.py, chip_smoke.py).
BRIGHT = 0.8


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The JAX scene, the hash tapes, the kernels' camera rays (float32
    constants, the op order of the TPU kernel's _camera_ray_from_pix),
    two cotangents (per ray, and per pixel spread over its rays) and the
    JAX gradients of sum(g . L) as a function of the parameters: built
    once per scene."""
    js, jp, jc = SCENES[name](dtype=jnp.float64) if name in (
        "cbox", "glossy") else SCENES[name]()
    jcfg = JaxConfig(**dataclasses.asdict(CFG))
    cam_u, tape = jax_hash_tapes(jnp.asarray(SEEDS, jnp.int32), NPIX,
                                 CFG.spp, CFG.max_depth, jnp.float64)
    cc = mk.camera_consts(from_numpy(
        *([np.asarray(a) for a in t] for t in (js, jp, jc)),
        device="cpu")[2], CFG.width, CFG.height)
    cu = torch.as_tensor(np.array(cam_u))
    o, d = mk.camera_ray_from_pix(cc, torch.arange(N) % NPIX, cu[0], cu[1])
    jo, jd = (JV3(*(jnp.asarray(c.numpy()) for c in v)) for v in (o, d))
    r = np.random.default_rng(7)
    g_ray = r.uniform(0.5, 1.5, size=(3, N))
    g_pix = r.uniform(0.5, 1.5, size=(3, NPIX))
    grads = None if name.startswith("wide") else _jax_grads(js, jcfg, jo,
                                                           jd, tape)
    return dict(js=js, jp=jp, jc=jc, jcfg=jcfg, jo=jo, jd=jd, cc=cc, cu=cu,
                tape=tape, o=o, d=d, g_ray=g_ray, g_pix=g_pix, grads=grads)


def _jax_grads(js, jcfg, jo, jd, tape):
    """(d_albedo, d_emission) of sum(w . L) under jax.grad of the JAX
    package's tape diff renderer, as a jitted function of (params, w)."""
    f = jax_make_diff_renderer(js, jcfg, use_tape=True)

    @jax.jit
    def grads(p, w):
        def loss(p):
            L = f(p, jo, jd, tape)
            return sum(jnp.dot(c, wc) for c, wc in zip(L, w))
        g = jax.grad(loss)(p)
        return g.albedo, g.emission
    return grads


def _params(name, albedo=None):
    """The JAX parameters of scene `name`, every albedo `albedo` (None:
    the scene's own)."""
    jp = _setup(name)["jp"]
    if albedo is not None:
        jp = jp._replace(albedo=jnp.full_like(jp.albedo, albedo))
    return jp


@functools.lru_cache(maxsize=None)
def _rows(name, albedo=None) -> dict:
    """`_residuals` of scene `name` with `_params(name, albedo)`, once."""
    st = _setup(name)
    return _residuals(st["js"], _params(name, albedo), st["jcfg"], st["jo"],
                      st["jd"], st["tape"])


@functools.lru_cache(maxsize=None)
def case(name, albedo=None):
    """Both packages' scene with every albedo `albedo` (None: the
    scene's own), the draws, rays and cotangents, and the JAX gradients
    for each cotangent."""
    st = _setup(name)
    jp = _params(name, albedo)
    scene, params, _ = from_numpy(
        *([np.asarray(a) for a in t] for t in (st["js"], jp, st["jc"])),
        device="cpu")
    grads = (_residual_grads(_rows(name, albedo)) if st["grads"] is None
             else functools.partial(st["grads"], jp))
    ref = {}
    for label, w in (("ray", st["g_ray"]),
                     ("pixel", np.tile(st["g_pix"], CFG.spp))):
        ref[label] = tuple(np.asarray(t) for t in grads(jnp.asarray(w)))
    t = torch.as_tensor
    return dict(
        scene=scene, params=params, cc=st["cc"],
        alb=albedo_table(scene, params), emi=emission_table(scene, params),
        cam_u=st["cu"], tape=t(np.array(st["tape"])),
        o=torch.stack(tuple(st["o"])), d=torch.stack(tuple(st["d"])),
        g={"ray": t(st["g_ray"]), "pixel": t(st["g_pix"])}, ref=ref)


def _residuals(js, jp, jcfg, jo, jd, tape) -> dict:
    """The JAX tape form's residuals (trace_rays(collect=True)) in numpy:
    P [D, N, 3], sc and gate [D, N, 1], the rows aid and eid [D, N], and
    the tables with their sentinel rows."""
    _, res = jax_trace_rays(jp, js, jo, jd, None, jcfg, tape=tape,
                            collect=True)
    return dict(
        P=np.stack([np.asarray(c) for c in res.P], axis=-1),
        sc=np.asarray(res.sc)[..., None], gate=np.asarray(res.gate)[..., None],
        aid=np.asarray(res.aid), eid=np.asarray(res.eid),
        alb=np.concatenate([np.asarray(jp.albedo), np.ones((1, 3))]),
        emi=np.concatenate([np.asarray(jp.emission), np.zeros((1, 3))]))


def _residual_grads(r: dict):
    """The gradients from the JAX tape form's residuals `r` (`_residuals`)
    and the reverse sweep of drt_tpu.adjoint._param_grads written out in
    numpy, for the wide scenes: its jitted form unrolls a masked sum per
    table row, which takes 20 s to compile at 256 rows. Held to jax.grad
    on a wide scene of 6 + 4 rows by
    test_the_wide_scenes_reference_is_the_jax_gradient."""
    P, sc, gate, aid, eid, alb, emi = (
        r[k] for k in ("P", "sc", "gate", "aid", "eid", "alb", "emi"))

    def grads(w):
        g = np.asarray(w).T  # [N, 3]
        S = np.zeros_like(g)
        da, de = np.zeros_like(alb), np.zeros_like(emi)
        for b in reversed(range(P.shape[0])):
            gP = g * P[b]
            np.add.at(de, eid[b], gP)
            np.add.at(da, aid[b], gP * sc[b] * S)
            S = (emi[eid[b]] + alb[aid[b]] * sc[b] * S) * gate[b]
        return da[:-1], de[:-1]

    return grads


def _assert_grads(got, ref, tol=TOL):
    da, de = (t.numpy() for t in got)
    ra, re_ = ref
    assert np.abs(ra).max() > 0 and np.abs(re_).max() > 0
    np.testing.assert_allclose(da[:-1], ra, **tol)
    np.testing.assert_allclose(de[:-1], re_, **tol)
    assert not da[-1].any() and not de[-1].any()  # the sentinel rows


@functools.lru_cache(maxsize=None)
def case32(name):
    """`case`'s scene, draws and cotangents in float32, for the
    memory-resident family (its DynScene, and its reference: the float64
    JAX gradients)."""
    c = case(name)
    scene = type(c["scene"])(*(t.float() if t.is_floating_point() else t
                               for t in c["scene"]))
    f32 = {k: c[k].float() for k in ("alb", "emi", "cam_u", "tape")}
    return dict(c, scene=scene, ds=dk.DynScene(scene), **f32,
                g={k: v.float() for k, v in c["g"].items()})


def _longest_sample(rows: torch.Tensor, trips: torch.Tensor,
                    want_bit: int) -> int:
    """The most trips one sample of a pixel takes, from the want bits of
    a regeneration collect form's rows [1, t_cap, n_pix]."""
    longest = 0
    for p in range(rows.shape[2]):
        t = int(trips[0, p])
        starts = np.flatnonzero((rows[0, :t, p].numpy() >> want_bit) & 1)
        longest = max(longest, *np.diff(np.append(starts, t)))
    return longest


def _live_past_32(live_rows: torch.Tensor) -> int:
    """Live bounce-slots past bounce 32 (rows [D, N])."""
    n = int(live_rows[32:].sum())
    assert n > 0, "no path lives past bounce 32: the test sees nothing deep"
    return n


@pytest.mark.parametrize("cot", ["ray", "pixel"])
@pytest.mark.parametrize("name", ["cbox", "glossy"])
def test_fused_sweep_and_retrace_adjoint_past_32_bounces(name, cot):
    """B3 on the collect tracer's rows and B4 (tape form, per-ray and
    per-pixel cotangent) = jax.grad of the tape diff renderer."""
    c = case(name, BRIGHT)
    tape_kw = dict(cam_u=c["cam_u"], tape=c["tape"])
    _, rsc, rbest = mk.fused_collect_plain(c["scene"], c["cc"], CFG,
                                           c["alb"], c["emi"], **tape_kw)
    assert rsc.shape == (CFG.max_depth, N)
    _live_past_32(rbest > 0)
    g = c["g"][cot]
    _assert_grads(mk.fused_sweep_plain(c["scene"], CFG, c["alb"], c["emi"],
                                       rsc, rbest, g), c["ref"][cot])
    _assert_grads(mk.fused_adjoint_plain(c["scene"], c["cc"], CFG, c["alb"],
                                         c["emi"], g, **tape_kw),
                  c["ref"][cot])


@pytest.mark.parametrize("name", ["cbox", "glossy"])
def test_wavefront_adjoint_past_32_bounces(name):
    """B5b on the camera rays and the tape, per-ray cotangent."""
    c = case(name, BRIGHT)
    got = mk.ray_adjoint_plain(c["scene"], CFG, c["alb"], c["emi"], c["o"],
                               c["d"], c["tape"], c["g"]["ray"])
    _assert_grads(got, c["ref"]["ray"])


@pytest.mark.parametrize("cot", ["ray", "pixel"])
@pytest.mark.parametrize("name", ["cbox", "glossy", "wide150", "wide255"])
def test_dyn_sweep_and_retrace_adjoint_past_32_bounces_and_144_rows(
        name, cot):
    """B8 on the dyn collect tracer's rows and B9, on the scene-table
    scenes and on scenes of 150 and 255 + 255 real table rows."""
    c = case32(name)
    ds = c["ds"]
    tape_kw = dict(cam_u=c["cam_u"], tape=c["tape"])
    rows = c["alb"].shape[0] - 1 + c["emi"].shape[0] - 1
    assert name.startswith("wide") == (rows > dk.MAX_GRAD_ROWS)
    _, rsc, rrow = dk.dyn_collect_plain(ds, c["cc"], CFG, c["alb"], c["emi"],
                                        **tape_kw)
    _live_past_32((rrow >> (2 * dk._ROW_BITS)) & 1)
    g = c["g"][cot]
    _assert_grads(dk.dyn_sweep_plain(CFG, c["alb"], c["emi"], rsc, rrow, g),
                  c["ref"][cot], F32_TOL)
    if cot == "ray":  # the retrace form: its own collect, then the sweep
        _assert_grads(dk.dyn_adjoint_plain(ds, c["cc"], CFG, c["alb"],
                                           c["emi"], g, **tape_kw),
                      c["ref"][cot], F32_TOL)


@pytest.mark.parametrize("name", ["cbox", "glossy"])
def test_regen_sweep_past_32_bounces(name):
    """B11 on the regeneration collect form's rows: its samples are the
    lockstep slots' paths, so its gradient with a per-pixel cotangent is
    the tape diff renderer's on the hash tapes."""
    c = case(name, BRIGHT)
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    _, rsc, rmeta, trips = rg.regen_collect_plain(
        c["scene"], c["cc"], CFG, c["alb"], c["emi"], seeds)
    assert rsc.shape == (1, rg.t_cap(CFG), NPIX)
    # Some sample takes more than 32 trips.
    assert _longest_sample(rmeta, trips, rg._WANT_BIT) > 32
    got = rg.regen_sweep_plain(c["scene"], CFG, c["alb"], c["emi"], rsc,
                               rmeta, trips, c["g"]["pixel"])
    _assert_grads(got, c["ref"]["pixel"])


@pytest.mark.parametrize("name", ["cbox", "wide150", "wide255"])
def test_dyn_regen_sweep_past_32_bounces_and_144_rows(name):
    """B13 on the dyn regeneration collect form's rows, per-pixel
    cotangent, on cbox and the wide scenes."""
    c = case32(name)
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    _, rsc, rrow, trips = dr.dyn_regen_collect_plain(
        c["ds"], c["cc"], CFG, c["alb"], c["emi"], seeds)
    assert _longest_sample(rrow, trips, dr._WANT_BIT) > 32
    got = dr.dyn_regen_sweep_plain(CFG, c["alb"], c["emi"], rsc, rrow, trips,
                                   c["g"]["pixel"])
    _assert_grads(got, c["ref"]["pixel"], F32_TOL)


def test_the_wide_scenes_reference_is_the_jax_gradient():
    """The wide scenes' reference (the JAX tape form's residuals and the
    reverse sweep of _param_grads in numpy) = jax.grad of the JAX
    package's tape diff renderer, float64 to rtol 1e-10, per-ray
    cotangent, on a wide scene small enough to compile (6 + 4 rows, 4
    triangles), every albedo BRIGHT so that the rows past 32 weigh."""
    st = _setup("wide10")
    r = _rows("wide10", BRIGHT)
    _live_past_32(torch.as_tensor(r["gate"][..., 0] > 0))
    w = jnp.asarray(st["g_ray"])
    ref = _jax_grads(st["js"], st["jcfg"], st["jo"], st["jd"], st["tape"])
    for got, want in zip(_residual_grads(r)(w),
                         ref(_params("wide10", BRIGHT), w)):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["wide150", "wide255"])
def test_dyn_sweep_in_float64_past_32_bounces_and_144_rows(name):
    """The plain B8 in float64 on the JAX tape form's own rows (their
    scattering terms sc and their rows packed as the dyn collect tracer
    packs them) over 150 and 255 + 255 real rows, every albedo BRIGHT, =
    the float64 reference to rtol 1e-10, per-ray and per-pixel cotangents:
    the memory-resident family's sweep sees the rows past 32 that weigh,
    which its float32 paths cannot show on the CPU."""
    st = _setup(name)
    r = _rows(name, BRIGHT)
    live = r["gate"][..., 0] > 0
    _live_past_32(torch.as_tensor(live))
    rsc = torch.tensor(r["sc"][..., 0])
    rrow = torch.as_tensor(
        (live.astype(np.int64) << (2 * dk._ROW_BITS))
        | (r["eid"].astype(np.int64) << dk._ROW_BITS)
        | r["aid"].astype(np.int64)).to(torch.int32)
    alb, emi = torch.as_tensor(r["alb"]), torch.as_tensor(r["emi"])
    sweep = _residual_grads(r)
    for w in (st["g_ray"], st["g_pix"]):
        ref = sweep(np.tile(w, (1, N // w.shape[1])))
        _assert_grads(dk.dyn_sweep_plain(CFG, alb, emi, rsc, rrow,
                                         torch.as_tensor(w)), ref)
