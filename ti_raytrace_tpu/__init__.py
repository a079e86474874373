"""ti_raytrace_tpu — a physically-based rendering framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
ti-raytrace reference renderer (a single-GPU Taichi megakernel path tracer).
Nothing here is a translation: the architecture is wavefront-style
fixed-shape ray batches over `jax.jit`-compiled passes, scenes are frozen
pytrees of SoA `jnp` arrays, the LBVH is built with `jax.lax.sort` +
vmapped Karras topology, and multi-chip scaling goes through
`jax.sharding.Mesh` + `shard_map` with pixel-tile sharding.

Layer map (mirrors SURVEY.md §1 of the reference):
  core/        constants, configs, RNG discipline
  utils/       math substrate (color, sampling, geometry, microfacet, morton)
  io/          OBJ/MTL, PNG, CSV loaders (host-side, numpy)
  scene/       scene pytree, builder, intersection, light sampling
  accel/       LBVH (device build) + SAH BVH (host build) + traversal
  ops/         tracers: dense sweep, Pallas (Triton) cluster kernel
  bsdf/        Disney principled BRDF, smooth dielectric glass
  spectral/    SPD tables, rgb2spec (Jakob–Hanika), hero-wavelength sampling
  sky/         Hosek–Wilkie full-spectral sky dome
  texture/     image textures (env map, albedo)
  integrators/ Debug AOV, PT_RGB, PT_Spec, BDPT_RGB, BDPT_SPEC
  parallel/    device-mesh sharding of the render loop
  examples/    the six reference scenes as configs + CLI harness
"""

__version__ = "0.1.0"
