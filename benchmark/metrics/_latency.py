"""Latencies of every query sent in the window, in ms: host clock from the
send to the returned BrokerResponse, stragglers past the close included."""

import numpy as np


def latencies_ms(run):
    return np.asarray([(r.t_done - r.t_send) * 1e3 for r in run.records
                       if r.t_done is not None])


def percentile(run, q):
    lat = latencies_ms(run)
    return float(np.percentile(lat, q)) if lat.size else None
