"""Constants and type ids (port of ``raytrace2_tpu/defs.py``).

Everything on the compute path is float32. The JAX package's f64
verification mode (``RAYTRACE2_DOUBLE``) belongs to its XLA path and has no
counterpart here yet. "Infinity" is float32's max, not IEEE inf, as in the
reference (src/Defs.hpp:7).
"""

from __future__ import annotations

import numpy as np

REAL = np.float32
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
