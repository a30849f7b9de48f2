"""The reduction of a profiler trace, on made-up events: the busy union,
device time by the host range that launched it, host time in a range, and
the idle gaps named by what the host was doing."""
import sys
from pathlib import Path

from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from h100_bench.tracing import Trace  # noqa: E402


class Event:
    def __init__(self, name, device, start, end, corr=0, annotation=False):
        self._v = (name, device, start, end, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def events():
    return [
        Event('bench.window', CPU, 0, 1000, annotation=True),
        Event('bench.request', CPU, 0, 900, annotation=True),
        Event('mlgk_setup', CPU, 10, 100, annotation=True),
        Event('mlgk_value_solve', CPU, 100, 300, annotation=True),
        Event('cudaLaunchKernel', CPU, 20, 25, corr=7),
        Event('cudaLaunchKernel', CPU, 150, 155, corr=8),
        Event('aten::mul', CPU, 18, 30, corr=8),
        Event('elementwise', CUDA, 30, 80, corr=7),
        Event('pcg_cluster_kernel', CUDA, 200, 500, corr=8),
        Event('mlgk_value_solve', CUDA, 200, 500, annotation=True),
        Event('untied', CUDA, 600, 650, corr=99),
    ]


def test_trace_reduction():
    tr = Trace(events())
    assert tr.window_s == 1e-6
    assert len(tr.ops) == 3 and tr.untied == 1
    assert abs(tr.busy_s() - 400e-9) < 1e-15
    assert abs(tr.device_s_in('mlgk_value_solve') - 300e-9) < 1e-15
    assert abs(tr.device_s_in('mlgk_setup') - 50e-9) < 1e-15
    assert abs(tr.host_s_in('mlgk_value_solve') - 200e-9) < 1e-15
    assert tr.device_ops()[0] == ['pcg_cluster_kernel', 300e-9]
    gaps = dict(tr.idle_gaps())
    # 0-30 ends at a launch in mlgk_setup; 80-200 at one in the value
    # solve; 500-600 at an untied op and 650-1000 at the window's end are
    # named by where they start, inside the request
    assert gaps == {'mlgk_setup': 30e-9, 'mlgk_value_solve': 120e-9,
                    'bench.request': 450e-9}
