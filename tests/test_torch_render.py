"""drt_tpu_torch's user surface on the CPU: routing
(`parallel.render`), the image renderer and the `render` and `grad`
CLI commands."""

import argparse
import json
import struct
import zlib

import numpy as np
import pytest
import torch

from drt_tpu_torch import cli
from drt_tpu_torch.config import RenderConfig
from drt_tpu_torch.fused import (_resolve_fastmath, make_fused_image_renderer,
                                 seeds_from_generator)
from drt_tpu_torch.models import cbox
from drt_tpu_torch.ops import megakernel as mk
from drt_tpu_torch.parallel.render import make_renderer, resolve_backend
from drt_tpu_torch.scene import albedo_table, emission_table

CFG = RenderConfig(width=16, height=12, spp=4, spp_chunks=2, max_depth=4)


def _seeds(seed=0):
    return seeds_from_generator(torch.Generator().manual_seed(seed))


def test_seeds_from_generator():
    s = _seeds(7)
    assert s.dtype == torch.int32 and s.shape == (2,)
    assert torch.equal(s, _seeds(7)) and not torch.equal(s, _seeds(8))


def test_cpu_render_reads_right():
    """The image semantics of the reference scene: light at the top,
    image-left red-dominant, image-right green-dominant (x-mirrored
    camera); every value finite; the plain path counts no launch."""
    scene, params, cam = cbox.build(device="cpu")
    assert resolve_backend(scene, CFG) == "torch"
    before = mk.fused_trace.launches
    img = make_renderer(scene, CFG, cam, differentiable=False)(
        params, _seeds())
    assert mk.fused_trace.launches == before
    assert img.shape == (12, 16, 3) and img.dtype == torch.float32
    assert not img.requires_grad and torch.isfinite(img).all()
    assert img[:3].mean() > 3 * img[-3:].mean()
    left, right = img[:, :4].mean((0, 1)), img[:, -4:].mean((0, 1))
    assert left[0] > 2 * left[1] and right[1] > 2 * right[0]
    img2 = make_renderer(scene, CFG, cam, differentiable=False,
                         backend="torch")(params, _seeds())
    assert torch.equal(img, img2)


def test_render_has_no_autograd_history():
    scene, params, cam = cbox.build(device="cpu")
    params = params._replace(albedo=params.albedo.requires_grad_())
    img = make_renderer(scene, CFG, cam, differentiable=False)(
        params, _seeds())
    assert img.grad_fn is None and not img.requires_grad


def test_tape_image_renderer_reduces_spp_outer():
    """rng="tape": pixel p is the mean of rays p, p + W*H, ... of the
    tracer's output; one tape per launch, biased only."""
    cfg = RenderConfig(width=8, height=6, spp=2, max_depth=3)
    scene, params, cam = cbox.build(device="cpu")
    r = np.random.default_rng(5)
    cam_u = torch.as_tensor(r.uniform(size=(2, 96)).astype(np.float32))
    tape = torch.as_tensor(r.uniform(size=(3, 3, 96)).astype(np.float32))
    img = make_fused_image_renderer(scene, cam, cfg, rng="tape")(
        params, cam_u, tape)
    L = mk.make_fused_tracer(scene, cam, cfg, rng="tape")(
        albedo_table(scene, params), emission_table(scene, params),
        cam_u, tape)
    assert img.shape == (6, 8, 3) and L.mean() > 0
    for y, x in ((0, 0), (2, 5), (5, 7)):
        p = y * 8 + x
        torch.testing.assert_close(img[y, x], (L[:, p] + L[:, p + 48]) / 2)
    for bad in (dict(spp_chunks=2), dict(unbiased=True)):
        with pytest.raises(ValueError, match="tape-mode"):
            make_fused_image_renderer(scene, cam, RenderConfig(
                width=8, height=6, spp=2, max_depth=3, **bad), rng="tape")


@pytest.mark.parametrize("fastmath,rng,fast", [
    ("auto", "internal", True), ("auto", "tape", False),
    (True, "tape", True), (False, "internal", False)])
def test_fastmath_auto_is_fast_for_internal_rng(fastmath, rng, fast):
    assert _resolve_fastmath(fastmath, rng) is fast


@pytest.mark.parametrize("kw,err,match", [
    (dict(backend="cuda"), ValueError, "CUDA device"),
    (dict(backend="xla"), ValueError, "'xla' is 'cuda-wavefront'"),
    (dict(mesh=object()), TypeError, "parallel.mesh.Mesh"),
    (dict(backend="pallas-dyn"), ValueError, "'pallas-dyn' is 'cuda-dyn'"),
    (dict(backend="cuda-dyn"), ValueError, "CUDA device"),
    (dict(backend="pallas-dyn-sharded"), ValueError,
     "'pallas-dyn-sharded' is 'cuda-dyn-sharded'"),
    (dict(backend="pallas-regen"), ValueError,
     "'pallas-regen' is 'cuda-regen'"),
    (dict(backend="pallas-dyn-regen"), ValueError,
     "'pallas-dyn-regen' is 'cuda-dyn-regen'"),
    (dict(backend="cuda-regen"), ValueError, "CUDA device"),
    (dict(backend="cuda-dyn-regen"), ValueError, "CUDA device"),
    (dict(backend="pallas-regen-sharded"), ValueError,
     "'pallas-regen-sharded' is 'cuda-regen-sharded'"),
    (dict(backend="pallas-split"), ValueError,
     "'pallas-split' is 'cuda-split'"),
    (dict(backend="bogus"), ValueError, "unknown backend"),
])
def test_make_renderer_refuses(kw, err, match):
    scene, _, cam = cbox.build(device="cpu")
    kw.setdefault("differentiable", False)
    with pytest.raises(err, match=match):
        make_renderer(scene, CFG, cam, **kw)


def test_cli_render_writes_png(tmp_path):
    out = tmp_path / "cbox.png"
    rc = cli.main(["render", "-x", "16", "-y", "12", "-n", "2",
                   "--max-depth", "3", "--device", "cpu", "-o", str(out)])
    assert rc == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (16, 12)
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:-16])
    px = np.frombuffer(raw, np.uint8).reshape(12, 1 + 16 * 3)[:, 1:]
    assert px.max() > 0


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """The default device is the card: without one the command fails and
    names `--device cpu`; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    args = ["render", "-x", "8", "-y", "6", "-n", "1", "--max-depth", "2",
            "-o", str(tmp_path / "a.png")]
    with pytest.raises(SystemExit, match="no CUDA device.*--device cpu"):
        cli.main(args)
    assert not (tmp_path / "a.png").exists()
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert (tmp_path / "a.png").exists()


def test_cli_f64_runs_the_plain_version_on_the_cpu(tmp_path):
    """`--f64` is the CPU validation mode: it implies `--device cpu`
    (with or without a card), and asking for the card with it fails
    naming `--f64`."""
    out = tmp_path / "f64.exr"
    args = ["-x", "8", "-y", "6", "-n", "2", "--max-depth", "3", "--f64",
            "-o", str(out)]
    assert cli.main(["render", *args]) == 0 and out.exists()
    parser = argparse.ArgumentParser()
    cli._add_render_flags(parser)
    scene, _, _, cfg = cli._build(parser.parse_args(args))
    assert scene.device.type == "cpu"
    assert scene.shape_geo.dtype == torch.float64
    assert resolve_backend(scene, cfg) == "torch"
    with pytest.raises(SystemExit, match="--f64 runs the plain version on "
                       "the CPU"):
        cli.main(["render", *args, "--device", "cuda"])


@pytest.mark.parametrize("flags,unbiased", [([], False),
                                            (["--unbiased",
                                              "--adjoint-samples", "2"],
                                             True)])
def test_cli_grad_writes_parameter_gradients(tmp_path, flags, unbiased):
    """`grad`: d mean(image) / d params through the differentiable
    renderer; diffuse albedo grads are positive where the wall is seen."""
    out = tmp_path / "grads.json"
    rc = cli.main(["grad", "-x", "16", "-y", "12", "-n", "4",
                   "--max-depth", "4", "--device", "cpu", *flags,
                   "-o", str(out)])
    assert rc == 0
    got = json.loads(out.read_text())
    assert got["backend"] == "torch" and got["unbiased"] is unbiased
    assert got["mean_intensity"] > 0
    d_alb, d_emi = np.array(got["d_albedo"]), np.array(got["d_emission"])
    assert d_alb.shape == (3, 3) and d_emi.shape == (1, 3)
    assert np.isfinite(d_alb).all() and (d_emi > 0).all()
    assert d_alb[0, 0] > 0 and d_alb[1, 1] > 0  # red and green walls


@pytest.mark.parametrize("backend", ["torch-regen", "torch-dyn-regen"])
def test_regen_backends_route_and_render(tmp_path, backend):
    """The plain regeneration backends render the lockstep backends'
    samples ("auto" never picks them); `--backend` of the CLI takes their
    names."""
    scene, params, cam = cbox.build(device="cpu")
    assert resolve_backend(scene, CFG, backend) == backend
    assert resolve_backend(scene, CFG) == "torch"
    img = make_renderer(scene, CFG, cam, differentiable=False,
                        backend=backend)(params, _seeds())
    lock = make_renderer(scene, CFG, cam, differentiable=False,
                         backend=backend.replace("-regen", ""))(
        params, _seeds())
    assert img.shape == (12, 16, 3) and lock.mean() > 0
    torch.testing.assert_close(img, lock, rtol=1e-5, atol=1e-7)
    out = tmp_path / "a.png"
    assert cli.main(["render", "-x", "8", "-y", "6", "-n", "2",
                     "--max-depth", "2", "--device", "cpu", "--backend",
                     backend, "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("channels", [3, 4])
def test_image_writers_match_jax_package(tmp_path, channels):
    """The numpy-only writers give drt_tpu.utils.image's PNG bytes, and
    EXRs that its reader reads back to the half-rounded image."""
    from drt_tpu.utils import image as jax_image
    from drt_tpu_torch.utils import image

    img = np.random.default_rng(3).uniform(
        0, 1.5, (6, 5, channels)).astype(np.float32)
    image.write_exr(str(tmp_path / "a.exr"), img)
    back = jax_image.read_exr(str(tmp_path / "a.exr"))
    np.testing.assert_array_equal(back[..., :channels],
                                  img.astype(np.float16))
    assert (back[..., 3] == 1.0).all() or channels == 4
    rgb = img[..., :3]
    image.write_png(str(tmp_path / "a.png"), rgb)
    jax_image.write_png(str(tmp_path / "b.png"), rgb)
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
