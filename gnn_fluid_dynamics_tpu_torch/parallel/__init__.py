"""Parallel training (counterpart of ``gnn_fluid_dynamics_tpu/parallel/``):
data parallelism, one process per card (:mod:`.data_parallel`)."""
