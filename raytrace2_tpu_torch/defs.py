"""Constants, type ids and the dtype policy (port of
``raytrace2_tpu/defs.py``).

``REAL`` is float32, as the reference compiles without ``DOUBLE``.
``RAYTRACE2_DOUBLE=1`` in the environment is the ``#define DOUBLE`` analog
(src/Defs.hpp:4-7), read once at import as in the JAX package: ``REAL``
becomes float64 (``TORCH_REAL`` its torch dtype), the loader builds float64
scenes, and the non-kernel path (camera rays, threefry uniforms, closest
hit, shading, the accumulator) computes in float64, a verification mode for
holding the f32 arithmetic against f64 ground truth. The kernels stay
float32: their packers cast the scene to float32, so the kernel routes'
images do not change under the toggle; the BVH walk computes in float32
too. "Infinity" is the REAL type's max, not IEEE inf, as in the reference
(src/Defs.hpp:7).
"""

from __future__ import annotations

import os

import numpy as np
import torch

DOUBLE = os.environ.get("RAYTRACE2_DOUBLE", "") not in ("", "0")
REAL = np.float64 if DOUBLE else np.float32
TORCH_REAL = torch.float64 if DOUBLE else torch.float32
INDEX = np.int32

INFINITY = REAL(np.finfo(REAL).max)

# Minimum hit distance for shading rays (src/cpu_raytrace/RayTracer.cpp:25).
T_MIN = REAL(1e-3)
# Quad parallel-ray epsilon (src/cpu_raytrace/Quad.cpp:22).
QUAD_EPS = REAL(1e-8)
# Near-zero scatter-direction epsilon (src/cpu_raytrace/Math.hpp:61-64).
NEAR_ZERO_EPS = REAL(1e-8)
# Constant-medium re-entry epsilon (src/cpu_raytrace/ConstantMedium.cpp:22).
MEDIUM_EPS = REAL(1e-4)
# AABB minimum side padding (src/cpu_raytrace/AABB.hpp:58-64).
AABB_PAD = REAL(1e-4)

# Material type ids.
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_TEXTURE = 3
MAT_DIFFUSE_LIGHT = 4
MAT_ISOTROPIC = 5
NUM_MAT_TYPES = 6

# Texture type ids.
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_NOISE = 2

# Noise type ids.
NOISE_PERLIN = 0
NOISE_MARBLE = 1

# Medium boundary type ids.
MEDIUM_SPHERE = 0
MEDIUM_BOX = 1

# Primitive record classes.
REC_SPHERE = 0
REC_QUAD = 1
REC_MEDIUM = 2
