"""Distributed execution on ``torch.distributed`` (port of
``ngp_tpu/dist``): the rank grid, the row-sharded (TP) encode, data- and
table-parallel NeRF training, frame-sharded rendering
(``NerfRenderer.render_multichip``), table-parallel image training and the
multi-scene orchestrator.

The JAX package drives a mesh of devices from one process; here every
rank is a process and the mesh is a grid of process groups
(``mesh.make_mesh``). Rays are embarrassingly parallel, so the batch is
split over the grid's ``data`` axis and the gradients are summed over it;
the hash table may be row-sharded over its ``model`` axis, each shard
contributing the corners of the rows it owns to a sum over the axis. The
MLPs are small and replicated.
"""
