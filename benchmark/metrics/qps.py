"""Queries completed in the window over the window's seconds."""


def read(run):
    done = sum(1 for r in run.records
               if r.t_done is not None and r.t_done <= run.t_stop)
    return done / run.seconds
