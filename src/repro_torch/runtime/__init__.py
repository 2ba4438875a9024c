"""Runtime (port of `repro.runtime`): seedable fault injection and the
fault-tolerant loop."""
from .chaos import FaultInjector, InjectedFault  # noqa: F401
from .fault import ElasticPlan, FaultTolerantLoop, StragglerMonitor, plan_remesh  # noqa: F401
