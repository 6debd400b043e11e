"""Multi-device serving of the port (the JAX package's ``distributed/``): the
mesh and its partition specs, the logical-axis rule sets, the paged arenas'
spec trees, the collective patterns and the GPipe forward."""
