// Device code shared by every tracer kernel of the port, scene-table
// (fused_body.cuh) and memory-resident (dyn_body.cuh) alike: the launch
// configuration, the state of a path, the keyed hash, the primary ray, the
// per-bounce uniforms, the BxDF sample + weight of one hit, one bounce of
// the reverse sweep, the persistent grid, the cp.async copies of the
// sweeps' rings and the section clock of the checking builds.
//
// Every library is built with -fmad=false, so the same expression rounds
// the same way in every instantiation: that is what makes a collect
// tracer's radiance its tracer's, and a retrace adjoint's residuals the
// collect tracer's, bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DRT_BLOCK 128

enum { PLANE = 0, SPHERE = 1, TRIANGLE = 2 };
enum { DIFFUSE = 0, SPECULAR = 1, MIRROR = 2, NULL_BXDF = 3 };
// Sign rule of pow(negative base, e): e not integral, even, odd.
enum { POW_NONINT = 0, POW_EVEN = 1, POW_ODD = 2 };

struct DrtCamera {
  float eye[3], fwd[3], right[3], up[3];
  float aspect_half, half;
};

struct DrtTrace {
  int width, height, n_rays, spp_c, n_chunks, max_depth, min_bounces;
  int n_shapes, n_alb, n_emi, internal_rng, fast;
  float absorb, inv_keep;
  uint32_t seed0, seed1;
  // The global index of slot 0 (a ray, or a pixel of the regeneration
  // kernels): a shard of a mesh traces slots [ray_base, ray_base + n_rays)
  // of the image's. The keyed draws, the camera ray and the pixel read it;
  // tapes, cotangents and outputs are indexed by the local slot.
  int ray_base;
};

static __device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// drt_tpu/ops/regen.py:_hash_bits + _bits_to_open_unit.
static __device__ __forceinline__ float hash_uniform(
    uint32_t seed, uint32_t pix, uint32_t s, uint32_t b, uint32_t dim) {
  uint32_t h = fmix(pix * 0x9E3779B9u + seed);
  h = fmix(h ^ (s * 0x85EBCA6Bu) ^ (b * 0xC2B2AE35u) ^ (dim * 0x27D4EB2Fu));
  int i23 = (int)(h >> 9);
  return ((float)i23 + 0.5f) * (1.0f / 8388608.0f);
}

// hash_uniform in two steps, bit for bit: the part that depends on the
// path only, fmix(pix * GOLD + seed) ^ s * C1 (XOR is associative), and
// the draw of bounce b, dim from it. A loop that draws many times per path
// keeps the key.
static __device__ __forceinline__ uint32_t path_key(uint32_t seed,
                                                    uint32_t pix,
                                                    uint32_t s) {
  return fmix(pix * 0x9E3779B9u + seed) ^ (s * 0x85EBCA6Bu);
}

static __device__ __forceinline__ float keyed_uniform(uint32_t key,
                                                      uint32_t b,
                                                      uint32_t dim) {
  const uint32_t h = fmix(key ^ (b * 0xC2B2AE35u) ^ (dim * 0x27D4EB2Fu));
  int i23 = (int)(h >> 9);
  return ((float)i23 + 0.5f) * (1.0f / 8388608.0f);
}

// max(x, 0) that keeps NaN, as jnp.maximum and torch.clamp do (fmaxf
// would turn NaN into 0).
static __device__ __forceinline__ float max0(float x) {
  return x < 0.0f ? 0.0f : x;
}

template <bool FAST>
static __device__ __forceinline__ float inv_sqrt(float x) {
  return FAST ? rsqrtf(x) : 1.0f / sqrtf(x);
}

static __device__ __forceinline__ float dot3(float ax, float ay, float az,
                                             float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// The state of one path between two bounces: the ray, the throughput,
// the radiance gathered so far and whether the path lives.
struct PathState {
  float ox, oy, oz, dx, dy, dz;
  float Tx, Ty, Tz;
  float lx, ly, lz;
  bool alive;
};

// Direction of the primary ray through pixel pix at the sub-pixel offsets
// (us, ut) (megakernel.py:_camera_ray_from_pix; camera.hpp:51-60).
template <bool FAST>
static __device__ __forceinline__ void primary_dir(
    const DrtTrace& cfg, const DrtCamera& cam, int pix, float us, float ut,
    float& dx, float& dy, float& dz) {
  const int py = pix / cfg.width;
  const int px = pix - py * cfg.width;
  float s = ((float)px + us) / (float)cfg.width;
  float t = ((float)py + ut) / (float)cfg.height;
  float a = (2.0f * s - 1.0f) * cam.aspect_half;
  float b = (2.0f * t - 1.0f) * cam.half;
  dx = (cam.fwd[0] + a * cam.right[0]) + b * (-cam.up[0]);
  dy = (cam.fwd[1] + a * cam.right[1]) + b * (-cam.up[1]);
  dz = (cam.fwd[2] + a * cam.right[2]) + b * (-cam.up[2]);
  float inv = inv_sqrt<FAST>(dx * dx + dy * dy + dz * dz);
  dx = dx * inv; dy = dy * inv; dz = dz * inv;
}

// The camera's two keyed draws of sample smp of pixel pix.
static __device__ __forceinline__ void camera_uniforms(
    const DrtTrace& cfg, int pix, uint32_t smp, float& us, float& ut) {
  us = hash_uniform(cfg.seed0, (uint32_t)pix, smp, 0u, 0u);
  ut = hash_uniform(cfg.seed0, (uint32_t)pix, smp, 0u, 1u);
}

// Primary ray of ray slot i in spp chunk c. Rays are spp-outer: the
// slot's global ray g = ray_base + i covers pixel g % (W*H) and sample
// c*spp_c + g / (W*H); a tape's cam_u is read at the local slot i.
template <bool FAST, bool INTERNAL>
static __device__ __forceinline__ void primary_ray(
    const DrtTrace& cfg, const DrtCamera& cam,
    const float* __restrict__ cam_u, int i, int c, int& pix, uint32_t& smp,
    float& dx, float& dy, float& dz) {
  const int npix = cfg.width * cfg.height;
  const int g = cfg.ray_base + i;
  pix = g % npix;
  smp = (uint32_t)(c * cfg.spp_c + g / npix);
  float us, ut;
  if (INTERNAL) {
    camera_uniforms(cfg, pix, smp, us, ut);
  } else {
    us = cam_u[i];
    ut = cam_u[cfg.n_rays + i];
  }
  primary_dir<FAST>(cfg, cam, pix, us, ut, dx, dy, dz);
}

// The (rr, u1, u2) uniforms of bounce bnc.
template <bool INTERNAL>
static __device__ __forceinline__ void bounce_uniforms(
    const DrtTrace& cfg, const float* __restrict__ tape, int i, int pix,
    uint32_t smp, int bnc, float& u_rr, float& u1, float& u2) {
  if (INTERNAL) {
    u_rr = hash_uniform(cfg.seed1, (uint32_t)pix, smp, (uint32_t)bnc, 0u);
    u1 = hash_uniform(cfg.seed1, (uint32_t)pix, smp, (uint32_t)bnc, 1u);
    u2 = hash_uniform(cfg.seed1, (uint32_t)pix, smp, (uint32_t)bnc, 2u);
  } else {
    const int N = cfg.n_rays;
    const float* ub = tape + (size_t)bnc * 3 * N;
    u_rr = ub[i];
    u1 = ub[N + i];
    u2 = ub[2 * N + i];
  }
}

// Shade (megakernel.py:_shade, dynkernel.py:_dyn_shade): sample dir_out
// (wx, wy, wz) and sc = s * cos / pdf for material type mt about the raw
// normal n, with d_in pointing away from the surface. `spec` gives the
// specular exponent e (expo()), 1 / (e + 2) (inv_e2()) and the sign rule
// of pow for it (pow_mode()); it is asked only in the specular branch.
// mt < 0 (a dead lane) and NULL_BXDF keep dir_out = 0, sc = 0.
template <bool FAST, class Spec>
static __device__ __forceinline__ void shade(
    int mt, const Spec& spec, float nx, float ny, float nz, float dinx,
    float diny, float dinz, float u1, float u2, float& wx, float& wy,
    float& wz, float& sc) {
  const float PI_F = 3.14159265358979323846f;
  const float TWO_PI_F = (float)(2.0 * 3.14159265358979323846);
  const float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
  wx = 0.0f; wy = 0.0f; wz = 0.0f; sc = 0.0f;
  if (mt == DIFFUSE || mt == SPECULAR) {
    // Frame about the raw normal (bxdf.hpp:29-41).
    const bool use_e1 = fabsf(nx) < fabsf(ny);
    const float tvx = use_e1 ? 1.0f - nx * nx : -nx * ny;
    const float tvy = use_e1 ? -ny * nx : 1.0f - ny * ny;
    const float tvz = use_e1 ? -nz * nx : -nz * ny;
    const float tinv = inv_sqrt<FAST>(dot3(tvx, tvy, tvz, tvx, tvy, tvz));
    const float tx = tvx * tinv, ty = tvy * tinv, tz = tvz * tinv;
    float bx = ny * tz - nz * ty;
    float by = nz * tx - nx * tz;
    float bz = nx * ty - ny * tx;
    const float binv = inv_sqrt<FAST>(dot3(bx, by, bz, bx, by, bz));
    bx = bx * binv; by = by * binv; bz = bz * binv;
    const float cos_phi = cosf(TWO_PI_F * u2);
    const float sin_phi = sinf(TWO_PI_F * u2);
    if (mt == DIFFUSE) {
      // theta = asin(sqrt(u1)): cos = sqrt(1-u1), sin = sqrt(u1).
      const float cos_t = sqrtf(max0(1.0f - u1));
      const float sin_t = sqrtf(u1);
      const float fx = cos_phi * sin_t, fy = sin_phi * sin_t;
      wx = (tx * fx + bx * fy) + nx * cos_t;
      wy = (ty * fx + by * fy) + ny * cos_t;
      wz = (tz * fx + bz * fy) + nz * cos_t;
      const float cos_geom = dot3(nx, ny, nz, wx, wy, wz);
      if (FAST) {
        sc = u1 < 1.0f ? cos_geom * rsqrtf(1.0f - u1) : 0.0f;
      } else {
        const float pdf = cos_t / PI_F;
        sc = pdf > 0.0f ? INV_PI_F * cos_geom / pdf : 0.0f;
      }
    } else {
      // Half-vector sampling (bxdf.hpp:106-120): cos_h = u1^(1/(e+2)).
      const float e = spec.expo();
      const float cos_h = powf(u1, spec.inv_e2());
      const float sin_h = sqrtf(max0(1.0f - cos_h * cos_h));
      const float fx = cos_phi * sin_h, fy = sin_phi * sin_h;
      float hx = (tx * fx + bx * fy) + nx * cos_h;
      float hy = (ty * fx + by * fy) + ny * cos_h;
      float hz = (tz * fx + bz * fy) + nz * cos_h;
      if (dot3(hx, hy, hz, dinx, diny, dinz) < 0.0f) {
        const float k = 2.0f * dot3(nx, ny, nz, hx, hy, hz);
        hx = -hx + k * nx; hy = -hy + k * ny; hz = -hz + k * nz;
      }
      const float k = 2.0f * dot3(hx, hy, hz, dinx, diny, dinz);
      wx = -dinx + k * hx; wy = -diny + k * hy; wz = -dinz + k * hz;
      // eval (bxdf.hpp:93-104) with the halfway vector recomputed
      // from dir_in and dir_out.
      float hwx = dinx + wx, hwy = diny + wy, hwz = dinz + wz;
      const float hw2 = dot3(hwx, hwy, hwz, hwx, hwy, hwz);
      const float hinv = inv_sqrt<FAST>(hw2);
      hwx = hwx * hinv; hwy = hwy * hinv; hwz = hwz * hinv;
      const float cos_he = dot3(nx, ny, nz, hwx, hwy, hwz);
      const float sin_he = sqrtf(max0(1.0f - cos_he * cos_he));
      // C++ pow for a negative base (ops/bxdf.py:_pow_cpp).
      const float mag = powf(fabsf(cos_he), e);
      const int pow_mode = spec.pow_mode();
      float powv;
      if (pow_mode == POW_NONINT)
        powv = cos_he < 0.0f ? __int_as_float(0x7fffffff) : mag;
      else if (pow_mode == POW_ODD)
        powv = mag * (cos_he < 0.0f ? -1.0f : 1.0f);
      else
        powv = mag;
      const float cos_geom = dot3(nx, ny, nz, wx, wy, wz);
      if (FAST) {
        const float denom = powf(cos_h, e + 1.0f) * sin_h;
        sc = (denom > 0.0f && hw2 > 0.0f)
                 ? powv * sin_he * cos_geom / denom : 0.0f;
      } else {
        const float norm = (e + 2.0f) / TWO_PI_F;
        const float pdf = norm * powf(cos_h, e + 1.0f) * sin_h;
        float s_val = norm * powv * sin_he;
        s_val = hw2 > 0.0f ? s_val : 0.0f;
        sc = pdf > 0.0f ? s_val * cos_geom / pdf : 0.0f;
      }
    }
  } else if (mt == MIRROR) {
    const float k = 2.0f * dot3(nx, ny, nz, dinx, diny, dinz);
    wx = -dinx + k * nx; wy = -diny + k * ny; wz = -dinz + k * nz;
    const float cos_geom = dot3(nx, ny, nz, wx, wy, wz);
    if (FAST)
      sc = cos_geom != 0.0f ? 1.0f : 0.0f;
    else
      sc = cos_geom != 0.0f ? (1.0f / cos_geom) * cos_geom : 0.0f;
  }
}

// The grid of a persistent kernel (the queues of fused_tracer.cu and
// fused_adjoint.cu, the sweeps of sweep_rows.cuh): as many blocks as stay
// resident on the card at once (the SMs times the blocks of the kernel an
// SM holds with `bytes` of dynamic shared memory each), or fewer when
// there are fewer ray slots.
template <class Kernel>
static cudaError_t queue_grid(Kernel kernel, int n, int* grid,
                              int bytes = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      DRT_BLOCK, bytes);
  const int need = (n + DRT_BLOCK - 1) / DRT_BLOCK;
  *grid = sms * per_sm < need ? sms * per_sm : need;
  if (*grid < 1) *grid = 1;
  return e;
}

// The cp.async copies of the sweeps' rings in shared memory (B3 and B8
// through sweep_rows.cuh, B11 and B13 through regen_window.cuh): a copy
// of 4 bytes from global to shared memory, which with pred false reads
// nothing and writes 0; the commit of the copies issued so far as one
// group; and the wait until at most `pending` (0 to 7) groups are in
// flight. Each carries a memory clobber, which keeps the compiler from
// moving the ring's shared-memory loads across a copy or a wait: without
// it a sweep could read a slot before its row has landed.
static __device__ __forceinline__ void ring_copy4(void* dst, const void* src,
                                                  bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

static __device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

static __device__ __forceinline__ void ring_wait(int pending) {
  switch (pending) {
#define DRT_WAIT(N)                                                        \
  case N:                                                                  \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory");            \
    break;
    DRT_WAIT(0) DRT_WAIT(1) DRT_WAIT(2) DRT_WAIT(3)
    DRT_WAIT(4) DRT_WAIT(5) DRT_WAIT(6)
#undef DRT_WAIT
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}

// The sections of a step that the checking builds time with clock64(), in
// the order a step runs them: the camera ray of a new path, the keyed draws
// and Russian roulette, the nearest-hit loop, gate + emission + normal +
// shade, the hook (the collect tracer's stores), albedo + throughput + next
// ray, and the loop's own work between steps.
enum { SEC_CAMERA = 0, SEC_DRAWS = 1, SEC_HIT = 2, SEC_SHADE = 3,
       SEC_HOOK = 4, SEC_TAIL = 5, SEC_LOOP = 6, N_SECT = 7 };

// The marks of a kernel that times nothing.
struct NoMarks {
  __device__ __forceinline__ void at(int, int, bool) {}
  __device__ __forceinline__ void step(bool, bool) {}
};

// The marks of a checking build: cycles per section, added by the first
// active lane of the warp at each mark (the lanes that run a section run
// it together), so that the sums are per warp-step; and, if `hist` is
// set, hist[bnc * 33 + k] counts the warp-steps of bounce bnc in which k
// of the warp's active lanes were alive after Russian roulette. step()
// counts the warp's steps the same way, in the lead lane's registers:
// global atomics at every step took a timed lockstep warp-bounce from
// 8070 to 25825 cycles (PERF.md section 6). NS sections:
// N_SECT in the tracers, more in the adjoints' timing build.
template <int NS>
struct SectionClockOf {
  unsigned long long cyc[NS];
  unsigned long long steps[4];
  unsigned long long* hist;
  long long t;
  __device__ __forceinline__ void start(unsigned long long* h) {
#pragma unroll
    for (int k = 0; k < NS; ++k) cyc[k] = 0ull;
#pragma unroll
    for (int k = 0; k < 4; ++k) steps[k] = 0ull;
    hist = h;
    t = clock64();
  }
  // Called by every active lane of the warp after a step: the lanes that
  // ran it (`ran`), the warp-step if any did, of those the lanes alive
  // after it, and the warp-step if any is.
  __device__ __forceinline__ void step(bool ran, bool alive) {
    const unsigned m = __activemask();
    const unsigned r = __ballot_sync(m, ran);
    const unsigned a = __ballot_sync(m, ran && alive);
    if ((int)(threadIdx.x & 31) != __ffs(m) - 1 || r == 0u) return;
    steps[0] += (unsigned long long)__popc(r);
    steps[1] += 1ull;
    steps[2] += (unsigned long long)__popc(a);
    steps[3] += a != 0u ? 1ull : 0ull;
  }
  __device__ __forceinline__ void at(int k, int bnc, bool alive) {
    const long long now = clock64();
    const unsigned m = __activemask();
    const bool lead = (int)(threadIdx.x & 31) == __ffs(m) - 1;
    if (lead) cyc[k] += (unsigned long long)(now - t);
    t = now;
    if (k == SEC_DRAWS && hist != nullptr) {
      const unsigned live = __ballot_sync(m, alive);
      if (lead) atomicAdd(hist + bnc * 33 + __popc(live), 1ull);
    }
  }
  // Adds the thread's sums into out[0 .. NS).
  __device__ __forceinline__ void flush(unsigned long long* out) const {
#pragma unroll
    for (int k = 0; k < NS; ++k)
      if (cyc[k] != 0ull) atomicAdd(out + k, cyc[k]);
  }
  // Adds the thread's step counts into out[0 .. 4), in step()'s order.
  __device__ __forceinline__ void flush_steps(unsigned long long* out) const {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (steps[k] != 0ull) atomicAdd(out + k, steps[k]);
  }
};
using SectionClock = SectionClockOf<N_SECT>;

// One bounce of the reverse sweep (megakernel.py:_reverse_sweep,
// dynkernel.py:_dyn_reverse_sweep) of one ray slot into its accumulator
// column: entry k lives at acc[k * DRT_BLOCK], albedo rows first (acc_a),
// then emission rows (acc_e), 3 entries each. arow / erow are the real
// table rows of the bounce, or -1 for a sentinel row (a = 1, e = 0).
//   d_emission[erow] += g P;  d_albedo[arow] += (g P) sc S
//   S = (e + a sc S) gate
static __device__ __forceinline__ void sweep_bounce(
    float* acc_a, float* acc_e, int arow, int erow, const float a[3],
    const float e[3], const float P[3], float sc, float gate,
    const float g[3], float S[3]) {
  const float gPx = g[0] * P[0], gPy = g[1] * P[1], gPz = g[2] * P[2];
  if (erow >= 0) {
    float* p = acc_e + erow * 3 * DRT_BLOCK;
    p[0] = p[0] + gPx;
    p[DRT_BLOCK] = p[DRT_BLOCK] + gPy;
    p[2 * DRT_BLOCK] = p[2 * DRT_BLOCK] + gPz;
  }
  if (arow >= 0) {
    float* p = acc_a + arow * 3 * DRT_BLOCK;
    p[0] = p[0] + gPx * sc * S[0];
    p[DRT_BLOCK] = p[DRT_BLOCK] + gPy * sc * S[1];
    p[2 * DRT_BLOCK] = p[2 * DRT_BLOCK] + gPz * sc * S[2];
  }
  S[0] = (e[0] + a[0] * sc * S[0]) * gate;
  S[1] = (e[1] + a[1] * sc * S[1]) * gate;
  S[2] = (e[2] + a[2] * sc * S[2]) * gate;
}
