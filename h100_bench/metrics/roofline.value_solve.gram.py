"""The value solve's share of its roofline, in percent: the least time of
the window's value solves on the card (``h100_bench/roofline.py``: the
larger of their bytes over the memory rate and their operations over the
float32 peak, counted from the graphs' unpadded sizes and the reference's
steps) over the device time of the operations launched inside the
program's ``mlgk_value_solve`` ranges."""
from h100_bench import roofline

UNIT = '%'
RANGE = 'mlgk_value_solve'


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_s_in(RANGE)
    work = run.work('value_solve')
    if not device_s or work is None:
        return None
    try:
        least, _ = roofline.least_seconds(*work, run.device_name)
    except KeyError:
        return None
    return 100.0 * least / device_s
