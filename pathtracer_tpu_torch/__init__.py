"""PyTorch/CUDA port of the wavefront path tracer.

Mirrors the layout of the JAX package `pathtracer_tpu` (accel/, scene/,
ops/, integrator/, parallel/, preview/, utils/, cli.py), which stays the reference each module is
held against.  The port imports `torch` and never `jax`, and nothing of the
JAX package: the host modules it needs (scene parser and OBJ loader, camera,
BVH build and its native builder, image I/O, render options) are its own
copies, each naming its counterpart.
"""
