"""Pages built into VAP indexes in the traced window per second of the
window, whoever built them: on the overlap lane the quanta drain
between a burst's dispatches and no ``tuning_cycle`` runs, so unlike
``vap_pages_per_s`` this reading has no gate on cycle walls.  The
harness counts the pages (each index's own built-page count or
coverage bitmap, read after every call, summed over its increases)."""


def read(run):
    if not run.traced or run.window_s <= 0:
        return None
    return run.vap_pages / run.window_s
