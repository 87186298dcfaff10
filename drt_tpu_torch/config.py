"""Render configuration: the same fields, defaults and validation as
`drt_tpu.config.RenderConfig`, so a config built for one package is
valid (or rejected with the same message) in the other.

The reference exposes width/height/samples/min-bounces/absorb-prob as CLI
flags (reference: src/args.hpp:19-67) and has unbounded recursion depth
terminated only by Russian roulette (pathtracer.hpp:121-136); the
wavefront needs a static trip count, so `max_depth` bounds the bounces.
"""

from __future__ import annotations

import dataclasses

# Byte budget of a splitting config's per-chunk lanes: 64 B of wavefront
# carry plus 12*max_depth B of prefix tape per lane. The per-vertex
# splitting estimator is exponential in depth by design
# (integrate.hpp:56-66); this turns a multi-TB allocation into a config
# error.
MAX_SPLIT_BYTES = 1 << 33


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) configuration for the wavefront tracer.

    Defaults mirror the reference CLI (src/args.hpp:24,32,40,48,56):
    640x480, 100 spp, min_bounces=1, absorb_prob=0.5.

    unbiased: backward retraces with fresh samples (integrate.hpp:11-24)
    instead of replaying the forward's. spp_chunks: sample chunks rendered
    one after another to bound live memory. bsdf_samples / adjoint_samples:
    the integration operator's n_samples in the forward estimator and in
    the unbiased backward (integrate.hpp:56-66, :15-19); both average.
    """

    width: int = 640
    height: int = 480
    spp: int = 100
    min_bounces: int = 1
    absorb_prob: float = 0.5
    max_depth: int = 32
    unbiased: bool = False
    spp_chunks: int = 1
    bsdf_samples: int = 1
    adjoint_samples: int = 1

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0 or self.spp <= 0:
            raise ValueError("width, height and spp must be positive")
        if not 0.0 <= self.absorb_prob < 1.0:
            raise ValueError(
                f"absorb_prob must be in [0, 1): {self.absorb_prob} "
                "(1.0 would make the RR reweighting 1/(1-absorb) infinite)")
        if self.min_bounces < 0:
            raise ValueError("min_bounces must be >= 0")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
        if self.min_bounces > self.max_depth:
            raise ValueError(
                f"min_bounces ({self.min_bounces}) exceeds max_depth "
                f"({self.max_depth}): no Russian roulette would ever run "
                "and the truncation-tail bound does not hold")
        if self.spp_chunks <= 0 or self.spp % self.spp_chunks != 0:
            raise ValueError(
                f"spp_chunks ({self.spp_chunks}) must divide spp "
                f"({self.spp}) evenly")
        if self.bsdf_samples < 1 or self.adjoint_samples < 1:
            raise ValueError("bsdf_samples and adjoint_samples must be >= 1")
        if self.bsdf_samples > 1:
            lanes_per_ray = self.bsdf_samples ** (self.max_depth - 1)
            rays = self.width * self.height * (self.spp // self.spp_chunks)
            total = rays * lanes_per_ray
            bytes_per_lane = 64 + 12 * self.max_depth
            if total * bytes_per_lane > MAX_SPLIT_BYTES:
                raise ValueError(
                    f"bsdf_samples={self.bsdf_samples} at max_depth="
                    f"{self.max_depth} expands each of the {rays} rays "
                    f"per chunk into bsdf_samples**(max_depth-1) = "
                    f"{lanes_per_ray} leaf lanes ({total:.3g} total; "
                    f"{total * bytes_per_lane:.3g} B of carry+prefix-tape "
                    f"> budget {MAX_SPLIT_BYTES} B); lower max_depth / "
                    "bsdf_samples / resolution / spp, or raise "
                    "spp_chunks")
