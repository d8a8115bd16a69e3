"""Holt-Winters index-utility forecaster (paper Section IV-C).

Port of ``repro.core.forecaster`` (``HWState``, ``init_state``,
``update``, ``forecast``, the batched forms and
``ShardHeatForecaster``), in float32 on the
database's device.  The multiplicative-seasonality equations:

    forecast:  y_hat(t+h|t) = (l_t + h * b_t) * s_{t - m + h_m}
    level:     l_t = alpha * (y_t / s_{t-m}) + (1-alpha) * (l_{t-1} + b_{t-1})
    trend:     b_t = beta  * (l_t - l_{t-1}) + (1-beta)  * b_{t-1}
    season:    s_t = gamma * (y_t / (l_{t-1} + b_{t-1})) + (1-gamma) * s_{t-m}

The operations and their order follow the reference one for one, and
so does the rounding.  XLA on the CPU contracts one product of each
update into a fused multiply-add (found by comparing every placement
bit for bit against the reference, jitted and vmapped, at several
alpha / beta / gamma):

    level:     fma(alpha, y / s_{t-m}, (1-alpha) * prev)
    trend:     fma(1-beta, b_{t-1}, beta * (l_t - l_{t-1}))
    season:    fma(gamma, y / prev, (1-gamma) * s_{t-m})
    forecast:  fma(h, b_t, l_t) * s

``_fma`` rounds once, as a fused multiply-add does.  The product of
two float32 values is exact in float64 (48 bits of mantissa); the
float64 sum with the addend is not, and rounding it to float32 would
round twice.  That differs from one rounding only where the float64
sum lands exactly halfway between two float32 values while the exact
sum does not: there the exact error term of the float64 addition
(TwoSum) says on which side of the midpoint the exact sum lies, and
``_fma`` takes that neighbour instead of the tie's even one.
tests/test_torch_forecaster.py builds such sums in ``update`` and
``forecast`` and holds them bit-equal to the reference.  ``1 - alpha`` is
taken in float32, as in the reference, where alpha is a traced
float32.  A batched state carries a leading batch axis on every
field; ``update_batch`` / ``forecast_batch`` are the reference's
vmapped forms.  Every operation is elementwise over the batch, so a
series keeps the bits it has as a scalar state: the tuner's Stage III
advances one batched state over every descriptor it has seen, and
``ShardHeatForecaster`` one over a table's shards.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.table import resolve_device

EPS = 1e-6


class HWState(NamedTuple):
    """Holt-Winters state for one (or, batched, many) time series."""

    level: torch.Tensor  # ()  or (n,) float32
    trend: torch.Tensor  # ()  or (n,) float32
    season: torch.Tensor  # (m,) or (n, m) multiplicative seasonal factors
    t: torch.Tensor  # () or (n,) int32 -- observations consumed


def init_state(season_len: int, batch: int | None = None,
               device=None) -> HWState:
    """Fresh state: level/trend unset (bootstrapped on first obs),
    seasonal factors start at 1; on ``device``, the card unless the
    caller names another."""
    shape = () if batch is None else (batch,)
    device = resolve_device(device)
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


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once (see the module docstring)."""
    p, c = a.double() * b.double(), c.double()  # p is exact
    s = p + c
    t = s - p  # TwoSum: p + c == s + e exactly
    e = (p - (s - t)) + (c - t)
    r = s.float()
    d = s - r.double()  # exact (Sterbenz)
    # On a tie, s is the midpoint of r and its neighbour r + 2d.
    n = s + d
    tie = (e != 0) & (d != 0) & n.isfinite() & (n.float().double() == n)
    return torch.where(tie & ((e > 0) == (d > 0)), n.float(), r)


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def update(state: HWState, y, alpha=0.5, beta=0.3, gamma=0.4) -> HWState:
    """Consume one observation ``y`` (scalar, or (n,) for a batched
    state).  The first observation bootstraps the level."""
    dev = state.level.device
    m = state.season.shape[-1]
    y = torch.clamp_min(_f32(y, dev), EPS)
    a, b, g = (_f32(v, dev) for v in (alpha, beta, gamma))
    pos = state.t % m
    s_tm = _take(state.season, pos)

    first = state.t == 0
    prev = state.level + state.trend
    prev = torch.clamp_min(prev, EPS)

    l_new = _fma(a, y / torch.clamp_min(s_tm, EPS), (1 - a) * prev)
    b_new = _fma(1 - b, state.trend, b * (l_new - state.level))
    s_new = _fma(g, y / prev, (1 - g) * s_tm)

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
    raw = _fma(_f32(int(h), s.device), state.trend, state.level) * s
    return torch.clamp_min(raw, 0.0)


def update_batch(state: HWState, ys, alpha=0.5, beta=0.3,
                 gamma=0.4) -> HWState:
    """``update`` over a batched state: one observation per series."""
    return update(state, ys, alpha, beta, gamma)


def forecast_batch(state: HWState, h=1):
    """``forecast`` over a batched state."""
    return forecast(state, h)


class ShardHeatForecaster:
    """Per-shard scan-cost forecaster (shard-aware tuning).

    One batched Holt-Winters state over a table's shards, on
    ``device`` (the card unless the caller names another), observed
    once per tuning cycle with the monitor's per-shard page-access
    counters and queried for next-cycle heat, so the tuner can route
    build quanta to the shards whose scans will cost the most.
    """

    def __init__(
        self,
        n_shards: int,
        season_len: int = 8,
        alpha: float = 0.5,
        beta: float = 0.3,
        gamma: float = 0.4,
        device=None,
    ):
        self.n_shards = n_shards
        self.params = (alpha, beta, gamma)
        self.state = init_state(season_len, batch=n_shards, device=device)

    def observe(self, heat) -> None:
        """Consume one cycle's per-shard pages-scanned vector."""
        y = np.asarray(heat, np.float32)[: self.n_shards]
        y = torch.from_numpy(y.copy()).to(self.state.level.device)
        self.state = update_batch(self.state, y, *self.params)

    def predict(self, h: int = 1) -> np.ndarray:
        """Next-cycle per-shard heat forecast (non-negative floats);
        all ones before the first observation."""
        if int(self.state.t[0]) == 0:
            return np.ones(self.n_shards)
        return forecast_batch(self.state, h).cpu().numpy().astype(np.float64)
