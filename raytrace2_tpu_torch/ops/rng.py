"""Counter-based RNG of the kernel path (port of the murmur family in
``raytrace2_tpu/ops/rng.py:100-153`` and the kernel-side helpers of
``ops/pallas/megakernel.py:401-430, 1356-1379, 1686-1691``).

Every draw is a pure function of (seed, pixel, sample, counter), so the port
reproduces the JAX package's streams bit for bit. uint32 words are held in
int64 tensors with values in [0, 2^32): torch has no ``>>`` for uint32 on
the CPU, and int32's ``>>`` is arithmetic. Each 32×32-bit multiply is split
into 16-bit halves so that no product leaves int64.
"""

from __future__ import annotations

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
