"""raytrace2_tpu_torch — the PyTorch/CUDA port of the raytrace2_tpu path tracer.

The JAX package ``raytrace2_tpu`` is the reference; this package mirrors its
module names (``scene/loader.py`` ↔ ``scene/loader.py`` and so on) so each
counterpart is easy to find. It imports ``torch`` and numpy and never
``jax``. The forward render runs through hand-written Hopper kernels: scenes
with ≤256 sweep records through ``csrc/megakernel_v4.cu`` (the port of the
JAX package's Pallas v4 path-regeneration kernel), bigger ones through the
sorted wavefront, whose K-bounce step is ``csrc/wavefront_step.cu``. On CPU
tensors the same entry points run each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
