"""Distribution over torch.distributed (port of femo_tpu/parallel/).

The JAX package distributes one program over a `jax.sharding.Mesh` with
`shard_map`.  Here every rank is a process of its own, started by
`launch.spawn`, and a `sharding.RankMesh` is that rank's view of the
process group.  Two modes, as in the JAX package:

* mode a, cells sharded (`sharding.py`): each rank assembles the
  residual, functional or dense Jacobian of its slice of the cells, and
  one all-reduce (`collectives.reduce_from_ranks`) gives every rank the
  whole; dof vectors stay replicated and the solves run replicated.
* mode b, dofs sharded (`halo.py`): each rank owns a block of dofs plus
  ghost copies of its partition boundary; the matvec exchanges halos with
  `all_to_all_single` and runs the element SpMV K4 on the rank's own
  elements; the distributed CG all-reduces its dot products.
* mode b inside the workload steps (`halo_step.py`): the shell and FSI
  steps with every linear solve, forward and adjoint, a halo CG over
  the composite (u, theta) dofs, preconditioned by Jacobi, Chebyshev or
  the per-rank block Jacobi (K1/K2 on each rank).
"""
