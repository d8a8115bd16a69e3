"""Statements completed in the window (scans, updates) per second of
the window's elapsed wall time: the paper's throughput."""


def read(run):
    return run.statements / run.window_s if run.window_s > 0 else None
