"""Mean wall time of one ``Database.execute_batch`` call (a read burst)
in the traced window, on the harness's timer, in ms.  The call reads
its answers back to the host, so it ends synchronised."""


def read(run):
    walls = run.burst_walls_s
    return 1e3 * sum(walls) / len(walls) if walls else None
