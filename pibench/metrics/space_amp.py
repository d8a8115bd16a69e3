"""Peak device bytes allocated in the window over the table's bytes of
user data (its value planes at capacity, rows x attributes x 4)."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / run.user_bytes
