"""tpu-raytracing: a physically-based wavefront path tracer in JAX.

Built from scratch in JAX/XLA (with a CUDA BVH walk for NVIDIA GPUs) with the
capabilities of the reference renderer `buggy213/opencl-raytracing`
(PBRT-inspired Rust + Embree + OptiX). See SURVEY.md for the structural map of
the reference this framework covers.

Layering (host -> device):
  geometry/ scene/   host-side scene description (numpy f32) + loaders
  accel/             BVH build (host; C++ or numpy) -> linearized device layout
  device/            scene -> SoA JAX buffers ("compiled scene")
  ops/               device math: RNG, intersection, traversal, BSDFs, textures
  integrator/        the wavefront path tracer (jit-compiled render loop)
  parallel/          device-mesh sharding (pixel tiles x spp, psum radiance)
  utils/             EXR/PNG IO, logging
  cli                command-line frontend (rttest-harness compatible)
"""

__version__ = "0.1.0"
