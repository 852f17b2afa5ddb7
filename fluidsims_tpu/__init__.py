"""fluidsims_tpu — a simulation engine in JAX, compiled by XLA for the GPU.

One engine, many solvers: re-creates the capabilities of the reference
`fluid-sims` solver collection (20 standalone CUDA/C programs) as a single
framework.  Grid solvers are fused stencil dataflow (XLA-fused jnp),
particle solvers offer a sort-based cell-dense layout beside the
reference's atomic scatter, and large domains shard across devices with
halo exchange (`jax.shard_map` + `lax.ppermute`).

Layer map (mirrors SURVEY.md §1):
  L1 config/geometry/BC   -> fluidsims_tpu.core.config, fluidsims_tpu.ops.sdf
  L2 state/memory         -> functional pytree state (no ping-pong needed)
  L3 numerics             -> fluidsims_tpu.ops
  L4 driver/stepping      -> fluidsims_tpu.core.stepper, core.clock, core.bench
  L5 render/export        -> fluidsims_tpu.render, fluidsims_tpu.io
"""

__version__ = "0.1.0"
