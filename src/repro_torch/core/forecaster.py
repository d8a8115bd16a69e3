"""Holt-Winters index-utility forecaster (paper Section IV-C).

Port of ``repro.core.forecaster`` (``HWState``, ``init_state``,
``update``, ``forecast`` and the batched forms), in float32 on the
database's device.  The multiplicative-seasonality equations:

    forecast:  y_hat(t+h|t) = (l_t + h * b_t) * s_{t - m + h_m}
    level:     l_t = alpha * (y_t / s_{t-m}) + (1-alpha) * (l_{t-1} + b_{t-1})
    trend:     b_t = beta  * (l_t - l_{t-1}) + (1-beta)  * b_{t-1}
    season:    s_t = gamma * (y_t / (l_{t-1} + b_{t-1})) + (1-gamma) * s_{t-m}

The operations and their order follow the reference one for one, so
the float32 results agree with it (tests/test_torch_executor.py checks
the values and the tuner decisions they drive).  A batched state
carries a leading batch axis on every field; ``update_batch`` /
``forecast_batch`` are the reference's vmapped forms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-6


class HWState(NamedTuple):
    """Holt-Winters state for one (or, batched, many) time series."""

    level: torch.Tensor  # ()  or (n,) float32
    trend: torch.Tensor  # ()  or (n,) float32
    season: torch.Tensor  # (m,) or (n, m) multiplicative seasonal factors
    t: torch.Tensor  # () or (n,) int32 -- observations consumed


def init_state(season_len: int, batch: int | None = None,
               device="cpu") -> HWState:
    """Fresh state: level/trend unset (bootstrapped on first obs),
    seasonal factors start at 1."""
    shape = () if batch is None else (batch,)
    return HWState(
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.ones(shape + (season_len,), dtype=torch.float32,
                   device=device),
        torch.zeros(shape, dtype=torch.int32, device=device),
    )


def _take(season, pos):
    return torch.gather(season, -1, pos.to(torch.int64).unsqueeze(-1)
                        ).squeeze(-1)


def update(state: HWState, y, alpha=0.5, beta=0.3, gamma=0.4) -> HWState:
    """Consume one observation ``y`` (scalar, or (n,) for a batched
    state).  The first observation bootstraps the level."""
    m = state.season.shape[-1]
    y = torch.as_tensor(y, dtype=torch.float32, device=state.level.device)
    y = torch.clamp_min(y, EPS)
    pos = state.t % m
    s_tm = _take(state.season, pos)

    first = state.t == 0
    prev = state.level + state.trend
    prev = torch.clamp_min(prev, EPS)

    l_new = alpha * (y / torch.clamp_min(s_tm, EPS)) + (1 - alpha) * prev
    b_new = beta * (l_new - state.level) + (1 - beta) * state.trend
    s_new = gamma * (y / prev) + (1 - gamma) * s_tm

    level = torch.where(first, y, l_new)
    trend = torch.where(first, 0.0, b_new)
    s_val = torch.where(first, 1.0, s_new)
    # keep factors sane on noisy series
    season = state.season.scatter(
        -1, pos.to(torch.int64).unsqueeze(-1),
        torch.clamp(s_val, 0.05, 20.0).unsqueeze(-1))
    return HWState(level, trend, season, state.t + 1)


def forecast(state: HWState, h=1):
    """h-step-ahead forecast y_hat(t+h|t); non-negative."""
    m = state.season.shape[-1]
    pos = (state.t + int(h) - 1) % m
    s = _take(state.season, pos)
    raw = (state.level + h * state.trend) * s
    return torch.clamp_min(raw, 0.0)


def update_batch(state: HWState, ys, alpha=0.5, beta=0.3,
                 gamma=0.4) -> HWState:
    """``update`` over a batched state: one observation per series."""
    return update(state, ys, alpha, beta, gamma)


def forecast_batch(state: HWState, h=1):
    """``forecast`` over a batched state."""
    return forecast(state, h)
