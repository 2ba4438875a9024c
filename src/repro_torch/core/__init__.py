"""Core of the port: overlapping blocks, the map-reduce engine, backends
and their calibration, the streaming monoid, fused plans, forecasts, frames
and the multi-tenant session, the halo exchange, the estimators, graphs
(§9, §11) and differencing (§1.4, §10.3)."""
from .backend import (AutoBackend, CircuitBreakerBackend, CudaBackend,  # noqa: F401
                      TorchBackend, get_backend, list_backends, register_backend,
                      resolve_device, set_default_backend)
from .frame import (Deferred, FrameSession, SeriesFrame, session_state_from_numpy,  # noqa: F401
                    session_state_to_numpy)
from .halo import halo_exchange, halo_exchange_grouped  # noqa: F401
from .integrity import lane_health, sentinel_scan  # noqa: F401
from .mapreduce import (block_partials, block_window_map_reduce,  # noqa: F401
                        scan_window_map_reduce, serial_window_map_reduce,
                        sharded_window_map_reduce, tree_sum)
from .overlap import (OverlapSpec, block_core, core_mask, make_overlapping_blocks,  # noqa: F401
                      reconstruct, replication_overhead)
from .plan import (StatPlan, analyze, anomaly_request, arma_request,  # noqa: F401
                   autocovariance_request, forecast_request, fused_engine, kernel_request,
                   moments_request, welch_request, yule_walker_request)
from .streaming import (PartialState, StreamingEngine, resolved_stat,  # noqa: F401
                        state_from_numpy, state_to_numpy)
from . import estimators  # noqa: F401
from .estimators import *  # noqa: F401,F403  (the estimator API, as the reference)
from .differencing import difference, difference_blocked, integrate  # noqa: F401
from . import graphs  # noqa: F401


def __getattr__(name):
    # ``calibrate`` (the module: calibrate.calibrate, its tables, its command
    # line) loads on first access, so that ``python -m
    # repro_torch.core.calibrate`` runs the module once, as __main__
    if name == "calibrate":
        import importlib

        return importlib.import_module(".calibrate", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
