"""Forecasts and anomaly scores served from the fused plan's lag state (port
of `repro.core.forecast`; paper §4, periodicity-seeded models after arXiv
1810.07776).

Prediction is itself a weak-memory computation: an AR / ARMA forecast needs
only the last max(p, q) observations and innovations.  A
:func:`forecast_request` (and :func:`anomaly_request`) joins a `StatPlan`
as a lag-family member, and its finalizer reads the plan's carried state
twice:

  * the shared lagged-sum entry, tail-corrected by
    ``_PlanGroup._corrected_gamma_sums`` (kernel 2 on the card), gives the
    fit: Yule-Walker for ``model="ar"``, innovations and a block solve
    (`estimators.arma.fit_arma`) for ``"arma"``, and a Yule-Walker solve
    restricted to a lag set (:func:`fit_seasonal_ar`) for ``"auto"``;
  * the carried tail (the last ``W_fused - 1`` samples) is the history the
    recurrence starts from: a forecast reads no data beyond what the
    estimation already carries.

Every function takes leading batch axes.  The reference ``vmap``s its
finalizers across a session's tenants; here a batched finalize
(`StatPlan.finalize_batch`) hands them states whose every leaf has a
leading tenant axis, and each step below is one batched tensor operation
for all tenants, so the number of operations does not grow with the
number of tenants.  ``model="auto"`` detects each tenant's period from the
plan's Welch member (a second call of its finalize, kernel 4 again) and
gathers and scatters by those per-tenant lags with a batch index.

Anomaly scores run the innovations filter over the carried tail against
the fitted model and standardize the residuals by the innovation
covariance; the first max(p, q) scored rows carry the filter's zero-start
transient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .estimators.prediction import arma_innovations_filter

__all__ = ["forecast_request", "anomaly_request", "ModelSpec", "resolve_model_spec",
           "detect_period", "fit_seasonal_ar", "lagged_forecast", "standardized_innovations",
           "make_forecast_finalizer", "make_anomaly_finalizer", "MODELS", "DEFAULT_MAX_PERIOD",
           "ARMA_RIDGE"]

MODELS = ("ar", "arma", "auto")
DEFAULT_MAX_PERIOD = 32
# Absolute ridge on the innovation recursion's V_k solves of the arma fit:
# keeps a batched finalize finite for near-empty tenants without measurably
# moving coefficients fitted from real data.
ARMA_RIDGE = 1e-8


# ---------------------------------------------------------------- requests
def forecast_request(horizon: int, model: str = "ar", p: int = 4, q: int = 1,
                     m: Optional[int] = None, max_period: Optional[int] = None,
                     name: Optional[str] = None):
    """Multi-horizon forecast from the plan's carried lag state.

    Finalizes to ``{"pred": (horizon, d), "sigma": (d, d)}`` (plus an int32
    ``"period"`` for ``model="auto"``).

    Args:
      horizon: steps ahead (>= 1).
      model: ``"ar"`` (Yule-Walker, order p), ``"arma"`` (innovations fit of
        ARMA(p, q)) or ``"auto"`` (AR on lags 1..p plus one seasonal lag at
        the detected period; the plan must also carry a Welch member).
      p / q / m: model orders; ``m`` is the arma recursion depth (default
        ``p + q``), ignored otherwise.
      max_period: auto only, the largest detectable seasonal lag (sets the
        member's window; default 32).
    """
    from .plan import StatRequest

    resolve_model_spec(model, p, q, m, max_period)  # validates
    if horizon < 1:
        raise ValueError(f"forecast horizon must be >= 1, got {horizon}")
    return StatRequest("forecast", name, (int(horizon), model, int(p), int(q), m, max_period))


def anomaly_request(model: str = "ar", p: int = 4, q: int = 1, m: Optional[int] = None,
                    max_period: Optional[int] = None, name: Optional[str] = None):
    """Standardized innovation residuals over the carried tail.

    Finalizes to ``{"z": (W-1, d), "score": (W-1,), "valid": (W-1,),
    "sigma": (d, d)}``: ``z`` per channel, ``score`` the Mahalanobis norm
    under the fitted innovation covariance, ``valid`` the right-aligned
    rows covered by ingested samples.  Models as :func:`forecast_request`.
    """
    from .plan import StatRequest

    resolve_model_spec(model, p, q, m, max_period)  # validates
    return StatRequest("anomaly", name, (model, int(p), int(q), m, max_period))


# ---------------------------------------------------------------- model spec
@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Resolved static structure of one forecast or anomaly member."""

    model: str
    p: int
    q: int
    m: int          # arma recursion depth (0 otherwise)
    lag_span: int   # largest lag the member reads: member window - 1

    @property
    def needs_welch(self) -> bool:
        return self.model == "auto"


def resolve_model_spec(model: str, p: int, q: int, m: Optional[int] = None,
                       max_period: Optional[int] = None) -> ModelSpec:
    """Validate the orders and resolve the member's lag span."""
    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    if p < 1:
        raise ValueError(f"need p >= 1, got p={p}")
    if q < 0:
        raise ValueError(f"need q >= 0, got q={q}")
    if model == "arma":
        depth = max(m if m is not None else p + q, p + q)
        return ModelSpec(model, p, q, depth, depth)
    if model == "auto":
        span = DEFAULT_MAX_PERIOD if max_period is None else int(max_period)
        # the seasonal lag lives in (p, span]
        if span < p + 1:
            raise ValueError(f"max_period={span} leaves no room for a seasonal lag beyond the "
                             f"p={p} short lags; need max_period >= {p + 1}")
        return ModelSpec(model, p, 0, 0, span)
    return ModelSpec(model, p, 0, 0, p)  # "ar"


# ------------------------------------------------------------- periodicity
def detect_period(psd: torch.Tensor, nperseg: int, min_period: int,
                  max_period: int) -> torch.Tensor:
    """Dominant period from a finalized one-sided PSD (..., F, d).

    The non-DC bin of largest power summed over channels (the first such
    bin on a tie), bin k -> round(nperseg / k) in float32 (half to even, as
    the reference), clipped into [min_period, max_period]: int32 (...,).
    """
    power = psd.sum(-1).clone()
    power[..., 0] = -torch.inf  # DC is trend, not seasonality
    k = torch.clamp(torch.argmax(power, -1), min=1)
    period = torch.round(nperseg / k.to(torch.float32)).to(torch.int32)
    return torch.clamp(period, min_period, max_period)


# ------------------------------------------------------------ seasonal fit
def fit_seasonal_ar(gamma: torch.Tensor, lags) -> Tuple[torch.Tensor, torch.Tensor]:
    """Yule-Walker restricted to a lag set.

    Fits X_t = sum_a A_a X_{t-l_a} + e_t from gamma(l_b) = sum_a
    gamma(l_b - l_a)^T A_a^T stacked over b; with lags 1..p this is the
    dense Yule-Walker system.  Lags may differ per series: ``gamma``
    (..., >= max(lags)+1, d, d) and ``lags`` (..., r) (or (r,) for every
    series) share their leading axes, and the gathers use a batch index.

    Returns A (..., r, d, d) aligned with ``lags``, sigma (..., d, d).
    """
    lead, (nl, d) = gamma.shape[:-3], gamma.shape[-3:-1]
    lags = torch.as_tensor(lags, device=gamma.device).long()
    r = lags.shape[-1]
    g = gamma.reshape((-1, nl, d, d))
    n = g.shape[0]
    lg = lags.reshape(-1, r).expand(n, r)
    H = lg[:, :, None] - lg[:, None, :]                     # l_b - l_a
    rows = torch.arange(n, device=gamma.device)
    G = g[rows[:, None, None], H.abs()]                     # (n, r, r, d, d)
    G = torch.where((H >= 0)[..., None, None], G, G.transpose(-1, -2))
    M = G.permute(0, 1, 3, 2, 4).reshape(n, r * d, r * d)
    Gl = g[rows[:, None], lg]                               # gamma(l_a): (n, r, d, d)
    sol = torch.linalg.solve_ex(M, Gl.reshape(n, r * d, d))[0]  # stacked A_a^T
    A = sol.reshape(n, r, d, d).transpose(-1, -2)
    sigma = g[:, 0] - torch.einsum("naij,najk->nik", A, Gl)
    return A.reshape(lead + (r, d, d)), sigma.reshape(lead + (d, d))


# ------------------------------------------------------------- recurrence
def lagged_forecast(Phi: torch.Tensor, Theta: torch.Tensor, xlag: torch.Tensor,
                    elag: torch.Tensor, steps: int) -> torch.Tensor:
    """Multi-horizon prediction by the companion-matrix recurrence, future
    innovations at their mean (zero).

    Args:
      Phi: (..., L, d, d) lag coefficients, Phi_l at index l-1 (zero rows
        elsewhere add exact zeros).
      Theta: (..., q, d, d) innovation coefficients.
      xlag: (..., L, d) observations, newest first.
      elag: (..., q, d) innovations, newest first.

    Returns (..., steps, d): X^_{t+1..t+steps}.
    """
    L, q = Phi.shape[-3], Theta.shape[-3]
    preds = []
    for _ in range(steps):
        pred = torch.einsum("...lij,...lj->...i", Phi, xlag)
        if q > 0:
            pred = pred + torch.einsum("...qij,...qj->...i", Theta, elag)
        if L > 0:
            xlag = torch.cat([pred[..., None, :], xlag[..., :-1, :]], -2)
        if q > 0:
            elag = torch.cat([torch.zeros_like(elag[..., :1, :]), elag[..., :-1, :]], -2)
        preds.append(pred)
    return torch.stack(preds, -2)


def standardized_innovations(Phi: torch.Tensor, Theta: torch.Tensor, x: torch.Tensor,
                             sigma: torch.Tensor,
                             eps: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor]:
    """Innovation residuals of ``x`` (..., T, d) under the fitted model,
    standardized: ``z`` divides each channel by its innovation standard
    deviation, ``score`` is the Mahalanobis norm sqrt(e^T Sigma^-1 e).

    Returns z (..., T, d), score (..., T).
    """
    _, innov = arma_innovations_filter(Phi, Theta, x)
    d = sigma.shape[-1]
    var = torch.clamp(torch.diagonal(sigma, dim1=-2, dim2=-1), min=eps)
    z = innov / torch.sqrt(var)[..., None, :]
    eye = torch.eye(d, dtype=sigma.dtype, device=sigma.device)
    w = torch.linalg.solve_ex(sigma + eps * eye, innov.transpose(-1, -2))[0].transpose(-1, -2)
    score = torch.sqrt(torch.clamp((innov * w).sum(-1), min=0.0))
    return z, score


# -------------------------------------------------------- plan finalizers
def _fitted_model(group, state, spec: ModelSpec):
    """(Phi (..., lag_span, d, d), Theta (..., q, d, d), sigma, period or
    None) from the plan group's tail-corrected lag sums."""
    from .estimators.stats import gamma_normalizer

    L = spec.lag_span
    s = group._corrected_gamma_sums(state, L)
    gamma = s * gamma_normalizer(state.length, L, "standard")[..., None, None]
    lead, d = gamma.shape[:-3], group.d
    zeros = lambda k: gamma.new_zeros(lead + (k, d, d))
    period = None
    if spec.model == "ar":
        from .estimators.yule_walker import yule_walker

        Phi, sigma = yule_walker(gamma, spec.p)
        Theta = zeros(0)
    elif spec.model == "arma":
        from .estimators.arma import fit_arma

        A, Theta, sigma = fit_arma(gamma, spec.p, spec.q, spec.m, ridge=ARMA_RIDGE)
        Phi = torch.cat([A, zeros(L - spec.p)], -3)
    else:  # auto: short lags 1..p plus one seasonal lag at the period
        info = group._welch_info[0]
        welch_member = next(mem for mem in group.members if mem.name == info.name)
        _, psd = welch_member.finalize(state)
        period = detect_period(psd, info.nperseg, spec.p + 1, L)
        short = torch.arange(1, spec.p + 1, dtype=torch.int32, device=gamma.device)
        lags = torch.cat([short.expand(lead + (spec.p,)), period[..., None]], -1)
        A, sigma = fit_seasonal_ar(gamma, lags)
        index = (lags.long() - 1)[..., None, None].expand(A.shape)
        Phi = zeros(L).scatter(-3, index, A)
        Theta = zeros(0)
    return Phi, Theta, sigma, period


def make_forecast_finalizer(group, horizon: int, spec: ModelSpec):
    """Finalizer of one forecast member of a `_PlanGroup`: fit from the
    shared lagged entry, seed the recurrence from the carried tail (arma:
    the innovations of filtering that same tail from zero), and run
    ``horizon`` steps.  Takes states with leading tenant axes."""

    def fin(state):
        Phi, Theta, sigma, period = _fitted_model(group, state, spec)
        tail = state.tail
        xlag = tail[..., tail.shape[-2] - spec.lag_span:, :].flip(-2)  # newest first
        if spec.q > 0:
            _, innov = arma_innovations_filter(Phi, Theta, tail)
            elag = innov[..., innov.shape[-2] - spec.q:, :].flip(-2)
        else:
            elag = tail[..., :0, :]
        out = {"pred": lagged_forecast(Phi, Theta, xlag, elag, horizon), "sigma": sigma}
        if period is not None:
            out["period"] = period
        return out

    return fin


def make_anomaly_finalizer(group, spec: ModelSpec):
    """Finalizer of one anomaly member: standardized innovations over the
    carried tail, rows before the series (or beyond the retained horizon in
    eviction mode) scored zero and flagged invalid."""

    def fin(state):
        Phi, Theta, sigma, period = _fitted_model(group, state, spec)
        tail = state.tail
        carry = tail.shape[-2]
        z, score = standardized_innovations(Phi, Theta, tail, sigma)
        rows = torch.arange(carry, device=tail.device)
        valid = rows >= carry - torch.clamp(state.length, max=carry)[..., None]
        out = {"z": torch.where(valid[..., None], z, 0.0),
               "score": torch.where(valid, score, 0.0), "valid": valid, "sigma": sigma}
        if period is not None:
            out["period"] = period
        return out

    return fin
