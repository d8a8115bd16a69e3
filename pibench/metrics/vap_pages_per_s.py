"""Pages built into VAP indexes in the traced window (each index's own
built-page count or coverage bitmap, read after every call, summed
over its increases) per second of the window."""


def read(run):
    if not run.cycle_walls_s or run.window_s <= 0:
        return None
    return run.vap_pages / run.window_s
