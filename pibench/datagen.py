"""The TUNER tables' data, made on the device from the run's seed.

Each attribute a_1..a_p follows the TUNER benchmark's law (Arulraj et
al., *Predictive Indexing*, Section V): Zipf with exponent 1.25, folded
into [1, 1M] by a multiplicative hash (``(x * 2654435761) mod 1M + 1``
in wrapping 64-bit arithmetic).  ``a_0`` is the row's timestamp, 1..n.
The draw is the rejection method numpy's ``Generator.zipf`` uses
(Devroye), vectorised: the same distribution, not numpy's stream.  Every
draw runs on the device from one ``torch.Generator`` seeded with the
run's seed, a column at a time, so the same seed on the same device
gives the same table bit for bit, and the benchmark makes it in seconds
where a host generator takes about a minute per 10M x 20 table.
"""

from __future__ import annotations

import numpy as np
import torch

ZIPF_A = 1.25
DOMAIN = 1_000_000
FOLD = 2654435761
INT64_MAX_AS_DOUBLE = float(2**63 - 1)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    return g


def zipf_column(n: int, gen: torch.Generator, device,
                a: float = ZIPF_A) -> torch.Tensor:
    """(n,) int64 Zipf(a) draws on ``device`` (Devroye's rejection
    method, as numpy draws one value, over whole batches)."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    filled = 0
    while filled < n:
        want = n - filled
        m = want + want // 4 + 1024
        u = 1.0 - torch.rand(m, dtype=torch.float64, device=device,
                             generator=gen)
        v = torch.rand(m, dtype=torch.float64, device=device, generator=gen)
        x = torch.floor(u.pow(-1.0 / am1))
        ok = (x >= 1.0) & (x <= INT64_MAX_AS_DOUBLE)
        x = torch.where(ok, x, torch.ones_like(x))
        t = (1.0 + 1.0 / x).pow(am1)
        ok &= v * x * (t - 1.0) / (b - 1.0) <= t / b
        got = x[ok][:want].to(torch.int64)
        out[filled:filled + got.numel()] = got
        filled += got.numel()
    return out


def fold(raw: torch.Tensor) -> torch.Tensor:
    """Zipf draws folded into [1, DOMAIN] as int32 (wrapping product,
    floored modulo, as numpy computes ``(raw * FOLD) % DOMAIN + 1``)."""
    return (torch.remainder(raw * FOLD, DOMAIN) + 1).to(torch.int32)


def fill_columns(plane, n_attrs: int, n_rows: int, seed: int) -> None:
    """Write the TUNER rows into the first ``n_rows`` slots of each
    attribute's plane; ``plane(a)`` returns attribute ``a``'s flat
    (capacity,) int32 plane.  Column 0 is the timestamp 1..n, columns
    1..p the folded Zipf draws, drawn in column order from one
    generator seeded with ``seed``."""
    first = plane(0)
    dev = first.device
    first[:n_rows] = torch.arange(1, n_rows + 1, dtype=torch.int32,
                                  device=dev)
    gen = generator(seed, dev)
    for a in range(1, n_attrs):
        plane(a)[:n_rows] = fold(zipf_column(n_rows, gen, dev))


def quantile_sample(column: torch.Tensor) -> np.ndarray:
    """The sorted values of one attribute column, on the host: every
    attribute shares the law, so scans and updates draw their bounds
    from the quantiles of a_1 (as the TUNER generator does)."""
    return torch.sort(column).values.cpu().numpy()
