"""PyTorch/CUDA port of the wavefront path tracer.

Mirrors the layout of the JAX package `pathtracer_tpu` (scene/, ops/,
integrator/, utils/, cli.py), which stays the reference each module is held
against.  Host-side modules that import no JAX (the scene parser and OBJ
loader, the camera, the BVH build, image I/O and the render options) are
imported from `pathtracer_tpu` rather than copied.  This package imports
`torch` and never `jax`.
"""
