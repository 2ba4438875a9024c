"""Main-path estimators of the port (reference: `repro.core.estimators`)."""
from .arma import fit_arma  # noqa: F401
from .innovation import innovation_algorithm  # noqa: F401
from .spectral import hann_window, welch_psd  # noqa: F401
from .stats import autocovariance, gamma_normalizer, mean  # noqa: F401
from .yule_walker import yule_walker  # noqa: F401
