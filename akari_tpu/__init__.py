"""AkariRender in JAX: a differentiable physically-based renderer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of AkariRender
(reference: a C++17 CPU/CUDA wavefront path tracer). The compute path is
pure-functional JAX compiled by XLA for the GPU; the dense ray-triangle
intersection for small scenes is a Pallas kernel (Triton route), BVH
traversal is XLA; multi-device scaling uses ``jax.sharding`` meshes with
XLA collectives.

Layer map (redesign of the reference's L0..L4 stack, SURVEY.md §1):

- ``core``        -- math/RNG/sampling/film primitives (ref: src/akari/common/)
- ``scene``       -- scene graph, loaders, compile-to-arrays (ref: core/nodes/)
- ``bvh``         -- host BVH build + device traversal (ref: kernel/bvh-accelerator.h)
- ``ops``         -- intersection ops w/ custom VJPs (ref: kernel/instance.h)
- ``shading``     -- BSDFs/materials/textures/lights (ref: kernel/material.h)
- ``integrators`` -- AO / wavefront path tracer (ref: kernel/integrators/)
- ``oracle``      -- NumPy reference implementation for golden tests
- ``parallel``    -- device-mesh sharding, multi-host (new; ref has none)
- ``diff``        -- inverse rendering (new; ref autodiff.h is an empty stub)
- ``utils``       -- logger/profiler/progress/config (ref: core/)
- ``cli``         -- render + import CLIs (ref: cmd/)
"""

__version__ = "0.1.0"
