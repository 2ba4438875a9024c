"""Estimators of the port (reference: `repro.core.estimators`)."""
from .arma import arma_psi_weights, fit_arma, fit_arma_streaming, solve_arma_from_psi  # noqa: F401
from .innovation import fit_ma, innovation_algorithm  # noqa: F401
from .mle import ar_conditional_nll, fit_ar_mle, fit_ar_sgd, optimal_step_size  # noqa: F401
from .prediction import (ar_forecast, ar_one_step, arma_forecast,  # noqa: F401
                         arma_innovations_filter)
from .spatial import (BandedARModel, BandedFitResult, SpatialPartition,  # noqa: F401
                      banded_nll, banded_predict, banded_predict_partitioned,
                      banded_to_dense, dense_to_banded, fit_banded_ar)
from .spectral import (ar1_theoretical_psd, hann_window, streaming_welch,  # noqa: F401
                       welch_chunk_kernel, welch_csd, welch_engine, welch_psd)
from .stats import (autocorrelation, autocovariance, autocovariance_blocked,  # noqa: F401
                    autocovariance_sharded, block_lag_sums, gamma_normalizer, lag_sum_engine,
                    mean, moment_engine, partial_autocorrelation, raw_lag_sums,
                    streaming_autocovariance, streaming_mean, streaming_window_moments,
                    windowed_moments)
from .yule_walker import (block_levinson, levinson_durbin, streaming_yule_walker,  # noqa: F401
                          yule_walker)

__all__ = ["mean", "autocovariance", "autocovariance_blocked", "autocovariance_sharded",
           "autocorrelation", "partial_autocorrelation", "windowed_moments", "lag_sum_engine",
           "moment_engine", "streaming_autocovariance", "streaming_window_moments",
           "streaming_mean", "yule_walker", "levinson_durbin", "block_levinson",
           "streaming_yule_walker", "innovation_algorithm", "fit_ma", "fit_arma",
           "arma_psi_weights", "fit_arma_streaming", "welch_chunk_kernel", "welch_engine",
           "streaming_welch", "ar_conditional_nll", "fit_ar_mle", "fit_ar_sgd",
           "optimal_step_size", "BandedARModel", "banded_predict", "banded_predict_partitioned",
           "fit_banded_ar",
           "SpatialPartition", "ar_one_step", "ar_forecast", "arma_innovations_filter",
           "arma_forecast", "welch_psd", "welch_csd", "hann_window", "ar1_theoretical_psd"]
