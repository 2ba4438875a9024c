"""Estimators of the port (reference: `repro.core.estimators`)."""
from .arma import fit_arma  # noqa: F401
from .innovation import innovation_algorithm  # noqa: F401
from .spatial import (BandedARModel, BandedFitResult, SpatialPartition,  # noqa: F401
                      banded_nll, banded_predict, banded_predict_partitioned,
                      banded_to_dense, dense_to_banded, fit_banded_ar)
from .spectral import hann_window, welch_csd, welch_psd  # noqa: F401
from .stats import autocovariance, gamma_normalizer, mean, windowed_moments  # noqa: F401
from .yule_walker import yule_walker  # noqa: F401
