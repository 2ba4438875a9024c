"""Distribution: the 1-D ``"data"`` mesh of SPMD ranks and its one
collective (port of `repro.parallel`, the statistics half)."""
from .sharding import (collective_count, data_mesh, gather_tree, mesh_axis_size,  # noqa: F401
                       mesh_device, mesh_rank, psum_tree, reset_collective_count, sum_ranks)
