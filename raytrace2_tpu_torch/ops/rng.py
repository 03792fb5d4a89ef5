"""Counter-based RNGs (port of ``raytrace2_tpu/ops/rng.py``): the threefry
family of the non-kernel path (:20-98) and the murmur family of the kernel
path (:100-153), with the kernel-side helpers of
``ops/pallas/megakernel.py:401-430, 1356-1379, 1686-1691``.

Every draw is a pure function of (seed, pixel, sample, counter), so the port
reproduces the JAX package's streams bit for bit. uint32 words are held in
int64 tensors with values in [0, 2^32): torch has no ``>>`` for uint32 on
the CPU, and int32's ``>>`` is arithmetic. Each 32×32-bit multiply is split
into 16-bit halves so that no product leaves int64.

A threefry key is an int64 tensor [..., 2] of its two words, as
``jax.random.key_data`` gives them (``jax_threefry_partitionable``, the
default: ``uniform`` hashes the counters (0, i) and xors the two output
words).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
# Camera draws use counters far above any bounce counter.
CAMERA_CTR_BASE = 0x40000000
_SAMPLE_MUL = 1000003
_NOISE_SEED = 0x5EEDBA5E


def as_u32(x) -> torch.Tensor:
    """uint32 word (int64 holder) of an integer or float tensor or a Python
    int. Floats truncate to int32 first and int32 wraps, as
    ``x.astype(int32).astype(uint32)`` does in JAX."""
    x = torch.as_tensor(x)
    if x.is_floating_point():
        x = x.to(torch.int32)
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c`` mod 2^32 for a uint32 word ``x`` and a constant ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def add32(x: torch.Tensor, y) -> torch.Tensor:
    return (x + y) & MASK32


def murmur_mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 words (JAX ``rng.murmur_mix`` / ``mk._mix``)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → U[0,1): top 24 bits → int32 → ×2⁻²⁴ (``mk._uniform_from_bits``)."""
    return (bits >> 8).to(torch.int32).to(torch.float32) * (1.0 / (1 << 24))


def v4_sample_key(seed, slot, sample) -> torch.Tensor:
    """Per-(pixel, sample) key ``mix(slot·G ^ mix(seed·1000003 + sample))``
    in exact uint32 arithmetic (``mk.v4_sample_key``)."""
    mega = add32(mul32(as_u32(seed), _SAMPLE_MUL), as_u32(sample))
    return murmur_mix(mul32(as_u32(slot), GOLDEN) ^ murmur_mix(mega))


def draw(key: torch.Tensor, ctr) -> torch.Tensor:
    """U[0,1) for counter ``ctr`` of the stream ``key`` (the bounce-side
    ``draw`` of ``mk._make_bounce``)."""
    c = add32(mul32(as_u32(ctr), GOLDEN), 1)
    return uniform_from_bits(murmur_mix(key ^ murmur_mix(c)))


def cam_draw(key: torch.Tensor, k: int) -> torch.Tensor:
    """Camera-draw stream, disjoint from bounce draws (``mk.cam_draw``)."""
    return draw(key, CAMERA_CTR_BASE + k)


def murmur_uniforms_at(mega_seed, pixel_ids, ctrs) -> torch.Tensor:
    """[N, len(ctrs)] f32 draws keyed by (seed·1000003 + sample, pixel id,
    counter) — JAX ``rng.murmur_uniforms_at``."""
    key = murmur_mix(mul32(as_u32(pixel_ids), GOLDEN) ^ murmur_mix(as_u32(mega_seed)))
    cols = []
    for c in ctrs:
        cu = add32(mul32(as_u32(c), GOLDEN), 1)
        bits = murmur_mix(key ^ murmur_mix(cu))
        cols.append((bits >> 8).to(torch.float32) * (1.0 / (1 << 24)))
    return torch.stack(cols, dim=-1)


murmur_uniforms = murmur_uniforms_at


def noise_seed(leaf: torch.Tensor) -> torch.Tensor:
    """Per-texture noise seed ``mix(u32(i32(leaf)) ^ 0x5EEDBA5E)``."""
    return murmur_mix(as_u32(leaf) ^ _NOISE_SEED)


def lattice_hash(ix, iy, iz, seed_u) -> torch.Tensor:
    """32-bit lattice hash for gradient noise (``mk._lattice_hash``);
    negative int32 lattice coordinates wrap to uint32."""
    h = mul32(as_u32(ix), 0x8DA6B343)
    h = h ^ mul32(as_u32(iy), 0xD8163841)
    h = h ^ mul32(as_u32(iz), 0xCB1AB31F)
    return murmur_mix(h ^ seed_u)


# ---- threefry2x32 (the non-kernel path) ---------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax.random's ``threefry_2x32``) on
    uint32 words; every argument broadcasts. Returns the two output words."""
    k0, k1, x0, x1 = (as_u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = add32(x0, ks[0]), add32(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add32(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = add32(x0, ks[(i + 1) % 3])
        x1 = add32(x1, add32(ks[(i + 2) % 3], i + 1))
    return x0, x1


def threefry_key(seed) -> torch.Tensor:
    """``jax.random.key(seed)`` as its two words (0, seed), [2]."""
    return torch.stack([torch.zeros((), dtype=torch.int64), as_u32(int(seed))])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key [..., 2] hashed with the counter
    (0, data); ``data`` broadcasts against the key's batch shape."""
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], 0, data), dim=-1)


def pixel_sample_key(seed, pixel_flat, sample_idx) -> torch.Tensor:
    """Base key of each (pixel, sample): fold_in(fold_in(key(seed), sample),
    pixel) (JAX :20-29). Returns [N, 2] for ``pixel_flat`` [N]."""
    key = fold_in(threefry_key(seed), int(sample_idx))
    pixel = as_u32(pixel_flat)
    return fold_in(key.to(pixel.device).expand(*pixel.shape, 2), pixel)


def bounce_key(base_key: torch.Tensor, bounce_idx) -> torch.Tensor:
    """Per-bounce subkey (JAX :32-34)."""
    return fold_in(base_key, bounce_idx)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(k, (n,))`` for every key of [N, 2] → [N, n]:
    counters (0, i), bits = x0 ^ x1, mantissa fill minus one."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., None, 0], key[..., None, 1], 0, i)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bounce_uniforms(keys: torch.Tensor, bounce_idx, n_draws: int) -> torch.Tensor:
    """One threefry draw per ray for a whole bounce (JAX :90-97): [N,
    n_draws] uniforms of fold_in(key, bounce)."""
    return uniform(fold_in(keys, bounce_idx), n_draws)


def unit_vec3_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform sphere direction from two uniforms (JAX :72-80), [..., 3]."""
    z = 1.0 - 2.0 * u1
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def disk_from_uniforms(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform unit-disk point (z = 0) by the polar map (JAX :83-87)."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)],
                       dim=-1)


def hash_gradient(ix, iy, iz, seed_u):
    """Unit gradient per lattice corner from two hashed uniforms
    (``mk._hash_gradient``)."""
    h1 = lattice_hash(ix, iy, iz, seed_u)
    h2 = murmur_mix(h1 ^ 0x68E31DA4)
    u1 = uniform_from_bits(h1)
    u2 = uniform_from_bits(h2)
    z = 1.0 - 2.0 * u1
    phi = (2.0 * 3.14159265358979) * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=1e-12))
    return r * torch.cos(phi), r * torch.sin(phi), z
