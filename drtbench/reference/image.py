"""Images and gradients of the reference: a configuration's scene and
shape, rendered over all of its pixels or a sample of them."""

from __future__ import annotations

import torch

from drtbench.reference import scene as scenes
from drtbench.reference.tracer import (RAY_BLOCK, RefScene, radiance,
                                       trace_paths)


def padded(albedo, emission):
    """The kernels' tables: albedo rows + a ones row (colourless), emission
    rows + a zeros row (no emitter)."""
    return (torch.cat([albedo, torch.ones_like(albedo[:1])]),
            torch.cat([emission, torch.zeros_like(emission[:1])]))


class Reference:
    """The reference renderer of one configuration (its `scene` and
    render settings) on `device`."""

    def __init__(self, config: dict, device):
        sc = config["scene"]
        self.cfg = config["render"]
        self.width = int(self.cfg["width"])
        self.height = int(self.cfg["height"])
        self.spp = int(self.cfg["spp"])
        self.npix = self.width * self.height
        data = scenes.build(sc["reference"], **sc.get("kwargs", {}))
        self.scene = RefScene(data, self.width, self.height, device)
        self.device = self.scene.device
        # Table rows are picked by products with one-hot rows: in full
        # float32, not TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        self.albedo = torch.as_tensor(data.albedo, dtype=torch.float32,
                                      device=self.device)
        self.emission = torch.as_tensor(data.emission, dtype=torch.float32,
                                        device=self.device)

    def paths(self, seeds, pixels=None, counts=None):
        """The paths of every sample of `pixels` (i64 indices, default all)
        under the seed pair: a list of blocks of rays. Ray r of n_sel * spp
        is sample r // n_sel of pixel pixels[r % n_sel]."""
        if pixels is None:
            pixels = torch.arange(self.npix, device=self.device)
        n_sel = pixels.shape[0]
        blocks = []
        for a in range(0, n_sel * self.spp, RAY_BLOCK):
            r = torch.arange(a, min(a + RAY_BLOCK, n_sel * self.spp),
                             device=self.device)
            blocks.append(trace_paths(self.scene, self.cfg, seeds, pixels,
                                      r % n_sel, r // n_sel, counts))
        return pixels, blocks

    def image(self, traced, albedo, emission, dtype=None):
        """f32[n_sel, 3]: the mean over samples of each selected pixel's
        radiance; dtype is that of the path weights and radiance."""
        pixels, blocks = traced
        alb, emi = padded(albedo, emission)
        img = torch.zeros((pixels.shape[0], 3), device=self.device)
        for bl in blocks:
            L = radiance(bl, bl.pixel.shape[0], alb, emi, dtype)
            img.index_add_(0, bl.pixel, L.float())
        return img / self.spp

    def vjp(self, traced, albedo, emission, cot, dtype=None):
        """(d albedo, d emission) of sum(image * cot), cot f32[n_sel, 3]."""
        pixels, blocks = traced
        leaves = [albedo.detach().requires_grad_(),
                  emission.detach().requires_grad_()]
        grads = [torch.zeros_like(albedo), torch.zeros_like(emission)]
        for bl in blocks:
            alb, emi = padded(*leaves)
            L = radiance(bl, bl.pixel.shape[0], alb, emi, dtype)
            s = (L.float() * (cot[bl.pixel] / self.spp)).sum()
            for acc, g in zip(grads, torch.autograd.grad(s, leaves)):
                acc += g.float()
        return grads
