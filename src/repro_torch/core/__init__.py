"""Core of the port: backends, the streaming monoid, fused plans, frames."""
from .backend import (CudaBackend, TorchBackend, get_backend, list_backends,  # noqa: F401
                      register_backend, resolve_device)
from .frame import Deferred, SeriesFrame  # noqa: F401
from .plan import (StatPlan, analyze, arma_request, autocovariance_request,  # noqa: F401
                   fused_engine, kernel_request, moments_request, welch_request,
                   yule_walker_request)
from .streaming import (PartialState, StreamingEngine, resolved_stat,  # noqa: F401
                        state_from_numpy, state_to_numpy)
