"""`ops.megakernel.trip_counts_plain`, the lane-trips each ray slot takes in
the queue of the fused tracers (csrc/fused_tracer.cu), against the same
count worked out here in numpy from the rows of the JAX package's collect
tracer (the Pallas kernel in interpret mode, tape mode, as
tests/test_torch_megakernel.py runs it): per chunk, 1 + the bounces b >= 1
at which the path was alive after bounce b - 1 (rbest > 0) and passed
Russian roulette (the tape's row (b, 0) against absorb_prob in f32).

The counts are integers and compared exactly: trip_counts_plain on the
JAX rows on every slot, and on the port's own collect twin's rows on every
slot whose rows all matter. A path that hit the light goes on with a zero
direction, and whether its next bounce hits is an ulp's choice (ROADMAP
C.4, tests/test_torch_fused_vjp.py:_matters): there the two packages may
take a trip more or less. The card's counter is held to trip_counts_plain
in tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drt_tpu.config import RenderConfig as JaxConfig
from drt_tpu.models import cbox as jax_cbox
from drt_tpu.models import gallery as jax_gallery
from drt_tpu.ops import megakernel as jax_mk
from drt_tpu.scene import albedo_table as jax_albedo_table
from drt_tpu.scene import emission_table as jax_emission_table
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.ops.rng import hash_tapes
from drt_tpu_torch.scene import albedo_table, emission_table, from_numpy

SCENES = {"cbox": jax_cbox.build, "glossy": jax_gallery.build_glossy}
CFG = RenderConfig(width=16, height=12, spp=2, max_depth=4)
N = CFG.width * CFG.height * CFG.spp


def _count(rbest: np.ndarray, tape: np.ndarray, cfg: RenderConfig):
    """The lane-trips of each slot from rows i32[D, N] and the tape."""
    b = np.arange(1, cfg.max_depth)[:, None]
    passes = (b < cfg.min_bounces) | ~(tape[1:, 0]
                                       < np.float32(cfg.absorb_prob))
    return 1 + ((rbest[:-1] > 0) & passes).sum(axis=0)


def _matters(sc, best):
    zero = (sc == 0) & (best > 0)
    return (np.cumsum(zero, axis=0) - zero) == 0


@pytest.fixture(scope="module", params=sorted(SCENES))
def rows(request):
    """The JAX collect tracer's rows (one build per scene) and the port's
    collect twin's, on the same numpy uniforms."""
    js, jp, jc = SCENES[request.param](dtype=jnp.float32)
    scene, params, cam = from_numpy(
        *([np.asarray(a) for a in t] for t in (js, jp, jc)), device="cpu")
    r = np.random.default_rng(3)
    cam_u = r.uniform(size=(2, N)).astype(np.float32)
    tape = r.uniform(size=(CFG.max_depth, 3, N)).astype(np.float32)
    _, rsc, rbest = jax_mk.make_fused_collect_tracer(
        js, jc, JaxConfig(**dataclasses.asdict(CFG)), tile_rows=1,
        rng="tape", interpret=True)(
        jax_albedo_table(js, jp), jax_emission_table(js, jp),
        jnp.asarray(cam_u), jnp.asarray(tape))
    _, p_rsc, p_rbest = mk.make_fused_collect_tracer(
        scene, cam, CFG, rng="tape")(
        albedo_table(scene, params), emission_table(scene, params),
        torch.as_tensor(cam_u), torch.as_tensor(tape))
    return dict(tape=tape, rsc=np.array(rsc), rbest=np.array(rbest),
                p_rsc=p_rsc.numpy(), p_rbest=p_rbest.numpy())


def test_trip_counts_on_the_jax_rows(rows):
    got = mk.trip_counts_plain(CFG, torch.as_tensor(rows["rbest"]),
                               tape=torch.as_tensor(rows["tape"]))
    ref = _count(rows["rbest"], rows["tape"], CFG)
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), ref)
    # Every path takes its first bounce; Russian roulette ends about half
    # of them at each bounce after it.
    assert ref.min() == 1 and ref.max() == CFG.max_depth
    assert 1.5 < ref.mean() < 2.2


def test_trip_counts_of_the_port_twin_match_jax(rows):
    got = mk.trip_counts_plain(CFG, torch.as_tensor(rows["p_rbest"]),
                               tape=torch.as_tensor(rows["tape"])).numpy()
    ref = _count(rows["rbest"], rows["tape"], CFG)
    whole = _matters(rows["rsc"], rows["rbest"]).all(axis=0)
    assert whole.mean() > 0.95
    np.testing.assert_array_equal(got[whole], ref[whole])


def test_trip_counts_internal_rng_equal_their_tapes():
    """With seeds, the roulette draws are the keyed hash of each chunk's
    slots: the count over two chunks equals the tape-mode counts of the
    chunks' hash tapes, summed."""
    cfg = dataclasses.replace(CFG, spp=4, spp_chunks=2)
    spp_c = cfg.spp // cfg.spp_chunks
    r = np.random.default_rng(4)
    rbest = torch.as_tensor(
        r.integers(0, 3, size=(2, cfg.max_depth, N)).astype(np.int32))
    seeds = [11, -12]
    got = mk.trip_counts_plain(cfg, rbest, seeds=seeds)
    ref = sum(mk.trip_counts_plain(
        cfg, rbest[c], tape=hash_tapes(seeds, 16 * 12, spp_c, cfg.max_depth,
                                       sample_base=c * spp_c)[1])
        for c in range(2))
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):
        mk.trip_counts_plain(cfg, rbest)
