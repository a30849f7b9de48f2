"""The 95th percentile of the latency of every predict request of the
window (host clock, from the request's start to its answer on the host;
numpy's linear interpolation between order statistics)."""
import numpy as np

UNIT = 'ms'


def read(run):
    lat = [r['t1'] - r['t0'] for r in run.done()
           if 'molecules' in r['record']]
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
