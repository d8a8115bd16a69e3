"""Mean wall time of one ``tuning_cycle`` in the traced window, in ms;
the harness's timer closes on a device synchronise."""


def read(run):
    walls = run.cycle_walls_s
    return 1e3 * sum(walls) / len(walls) if walls else None
