"""The port's Holt-Winters forecaster rounds each fused multiply-add once.

XLA on the CPU contracts one product of each update, and the forecast's
``l + h * b``, into a fused multiply-add (``repro_torch.core.forecaster``
module note).  The port emulates it in float64; a float64 sum that lands
exactly halfway between two float32 values while the exact sum does not
would round twice there.  These inputs are built to land on such a
midpoint, in ``update`` and in ``forecast``, and the port must stay
bit-equal to the reference's jitted forecaster on the CPU.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forecaster as R_hw
from repro_torch.core import forecaster as P_hw

F32 = np.float32


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _double_rounded(a, b, c):
    """The port's former emulation: float64 product and sum, then
    float32 -- two roundings."""
    return (torch.as_tensor(a, dtype=torch.float64)
            * torch.as_tensor(b, dtype=torch.float64)
            + torch.as_tensor(c, dtype=torch.float64)).float()


def _rounded_once(a, b, c):
    """float32(a * b + c) of the exact rational sum, ties to even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    lo = F32(float(exact))  # float64 rounding, then float32's neighbours
    cands = {lo, np.nextafter(lo, F32(np.inf)), np.nextafter(lo, F32(-np.inf))}
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(_bits(v)) & 1))
    return best


# (label, state fields, observation, alpha, beta, gamma, field, the
# halfway product).  Each one puts one fused multiply-add of ``update``
# exactly on a float32 midpoint in float64, with an exact error term
# that breaks the tie the other way from ties-to-even.
UPDATE_CASES = [
    # level: alpha * y = 0.75 * 2^40 (1 + 3 * 2^-23) is a midpoint whose
    # lower neighbour is even; (1 - alpha) * prev = 0.25 * EPS > 0 is
    # lost in float64 but lifts the exact sum above it.
    ("level", dict(level=0.0, trend=0.0, s_tm=1.0),
     2.0**40 * (1 + 3 * 2.0**-23), 0.75, 0.3, 0.4, "level"),
    # season: gamma * y / prev = 0.75 * 16 (1 + 3 * 2^-23) = 12 + 4.5 *
    # 2^-20, a midpoint with an even lower neighbour; (1 - gamma) * s_tm
    # = 2^-62 lifts the exact sum above it.
    ("season", dict(level=1.0, trend=0.0, s_tm=2.0**-60),
     16.0 * (1 + 3 * 2.0**-23), 0.5, 0.3, 0.75, "season"),
]


def _states(fields, m=4, t=1):
    season = np.ones(m, np.float32)
    season[t % m] = fields["s_tm"]
    ref = R_hw.HWState(jnp.float32(fields["level"]),
                       jnp.float32(fields["trend"]), jnp.asarray(season),
                       jnp.int32(t))
    port = P_hw.HWState(torch.tensor(fields["level"], dtype=torch.float32),
                        torch.tensor(fields["trend"], dtype=torch.float32),
                        torch.from_numpy(season.copy()),
                        torch.tensor(t, dtype=torch.int32))
    return ref, port


def _assert_states_equal(ref, port):
    for name in ("level", "trend", "season", "t"):
        np.testing.assert_array_equal(
            np.asarray(getattr(port, name).numpy()).view(np.int32),
            np.asarray(getattr(ref, name)).view(np.int32), err_msg=name)


@pytest.mark.parametrize("case", UPDATE_CASES, ids=[c[0] for c in UPDATE_CASES])
def test_update_halfway_sum_rounds_once_like_the_reference(case):
    _, fields, y, alpha, beta, gamma, field = case
    y = float(F32(y))
    rs, ps = _states(fields)
    rout = R_hw.update(rs, y, alpha, beta, gamma)
    pout = P_hw.update(ps, y, alpha, beta, gamma)
    _assert_states_equal(rout, pout)
    # The case does hit a midpoint: rounding twice gives another value.
    f = F32
    if field == "level":
        prev = max(f(fields["level"]) + f(fields["trend"]), f(P_hw.EPS))
        a, b = f(alpha), f(y) / max(f(fields["s_tm"]), f(P_hw.EPS))
        c = (f(1) - f(alpha)) * prev
        got = float(pout.level)
    else:
        prev = max(f(fields["level"]) + f(fields["trend"]), f(P_hw.EPS))
        a, b = f(gamma), f(y) / prev
        c = (f(1) - f(gamma)) * f(fields["s_tm"])
        got = float(pout.season[1])
    twice = float(_double_rounded(a, b, c))
    assert got == float(_rounded_once(a, b, c)) != twice


def test_update_batch_halfway_sums_match_the_reference():
    """The vmapped batch form: the two halfway series beside ordinary
    ones, in one batched state."""
    rng = np.random.default_rng(7)
    n, m = 6, 4
    level = rng.uniform(1, 100, n).astype(np.float32)
    trend = rng.uniform(-1, 1, n).astype(np.float32)
    season = rng.uniform(0.5, 2, (n, m)).astype(np.float32)
    ys = rng.uniform(1, 300, n).astype(np.float32)
    for i, (_, fields, y, *_rest) in enumerate(UPDATE_CASES):
        level[i], trend[i], season[i, 1] = (fields["level"], fields["trend"],
                                            fields["s_tm"])
        ys[i] = y
    # One smoothing triple for the batch: the level case's alpha and the
    # season case's gamma (each case's other products are not halfway).
    alpha, beta, gamma = 0.75, 0.3, 0.75
    t = np.ones(n, np.int32)
    rs = R_hw.HWState(jnp.asarray(level), jnp.asarray(trend),
                      jnp.asarray(season), jnp.asarray(t))
    ps = P_hw.HWState(*(torch.from_numpy(x.copy())
                        for x in (level, trend, season, t)))
    _assert_states_equal(R_hw.update_batch(rs, ys, alpha, beta, gamma),
                         P_hw.update_batch(ps, ys, alpha, beta, gamma))


@pytest.mark.parametrize("level", [-(2.0**-60), 2.0**-60])
def test_forecast_halfway_sum_rounds_once_like_the_reference(level):
    """3 * (1 + 2^-23) = 3 + 1.5 * 2^-22 is a midpoint whose upper
    neighbour is even; a level of -2^-60 pulls the exact sum below it
    (rounding twice differs), +2^-60 pushes it above (no difference)."""
    trend = 1 + 2.0**-23
    rs = R_hw.HWState(jnp.float32(level), jnp.float32(trend),
                      jnp.ones((4,), jnp.float32), jnp.int32(5))
    ps = P_hw.HWState(torch.tensor(level, dtype=torch.float32),
                      torch.tensor(trend, dtype=torch.float32),
                      torch.ones(4), torch.tensor(5, dtype=torch.int32))
    got = P_hw.forecast(ps, 3)
    assert _bits(got.numpy()) == _bits(R_hw.forecast(rs, 3))
    once = _rounded_once(F32(3), F32(trend), F32(level))
    assert float(got) == float(once)
    twice = float(_double_rounded(F32(3), F32(trend), F32(level)))
    assert (twice != float(once)) == (level < 0)


def test_fma_rounds_once_on_random_midpoints():
    """``_fma`` against the exactly rounded rational sum on inputs built
    to put the float64 sum on a float32 midpoint (and on ordinary
    inputs), both signs, both tie directions."""
    rng = np.random.default_rng(3)
    a, b, c = [], [], []
    for _ in range(400):
        # a * b = 3 * ma * 2^k with ma odd and 3 * ma < 2^25: 25
        # significant bits, the last one set -- a float32 midpoint; c
        # far below it is lost in float64 (or is 0: an exact tie).
        ma = int(rng.integers(2**22, (2**25 - 1) // 6)) * 2 + 1
        k = int(rng.integers(-20, 20))
        x = F32(3.0 * 2.0**int(rng.integers(-2, 3)))
        y = F32(ma * 2.0**(k - 23))
        sign = float(rng.choice([-1.0, 0.0, 1.0]))
        tiny = sign * abs(float(x) * float(y)) * 2.0**-int(
            rng.integers(60, 80))
        a.append(x)
        b.append(y)
        c.append(F32(tiny))
    ordinary = rng.uniform(-1e3, 1e3, (3, 400)).astype(np.float32)
    a = np.concatenate([np.array(a, np.float32), ordinary[0]])
    b = np.concatenate([np.array(b, np.float32), ordinary[1]])
    c = np.concatenate([np.array(c, np.float32), ordinary[2]])
    got = P_hw._fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_rounded_once(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    twice = _double_rounded(a, b, c).numpy()
    assert (_bits(twice) != _bits(want)).sum() > 50  # the cases bite
