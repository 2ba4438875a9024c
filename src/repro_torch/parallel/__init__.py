"""Distribution: the 1-D ``"data"`` mesh of SPMD ranks and its one
collective (port of `repro.parallel`, the statistics half), the
reference's logical-axis rule tables as data, and tensor parallelism over
the ``"model"`` axis of a 2-D mesh for the dense family's serving path
and train step (`tensor.py`)."""
from .sharding import (AbstractMesh, abstract_mesh, collective_bytes,  # noqa: F401
                       collective_count, collective_counts, collective_stage,
                       collective_stages, data_mesh, gather_tree,
                       logical_to_spec, mesh_axis_size, mesh_device, mesh_rank,
                       param_pspecs, param_tree,
                       psum_tree, reset_collective_count, set_sp_mode, shard_bytes,
                       shard_shape, sp_mode_enabled, sum_ranks, tree_shard_bytes,
                       zero1_pspecs)
from .tensor import (ModelShard, greedy_pick, model_mesh, reduce_model,  # noqa: F401
                     shard_params)
