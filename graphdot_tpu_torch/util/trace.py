"""The program's spans and counters, live only while a ``torch.profiler``
records.

:func:`span` names a stretch of host work in the profiler's trace, the
trace that also holds the device's kernels, so that a kernel is tied to
the span that launched it and an idle gap of the device to the span the
host was in. :func:`count` adds to a named counter. Both cost one read of
the profiler's flag while no profiler records, and then record nothing.

A counter's value is a host int or a device tensor. A tensor is kept as it
is (no reduction, no kernel, no wait on the device) and summed only when
:func:`counters` is read, so a profiled block runs the same kernels and
waits on the device at the same places as an unprofiled one::

    from torch.profiler import profile
    from graphdot_tpu_torch.util import trace

    trace.reset_counters()
    with profile() as prof:
        K = kernel(graphs)
    steps = trace.counters()   # {'cg_steps.value': ..., ...}
"""
import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()
_counters = {}


def recording():
    """Whether a ``torch.profiler`` records on this thread: what
    :func:`span` and :func:`count` read."""
    return torch.autograd._profiler_enabled()


def span(name):
    """A ``torch.profiler.record_function(name)`` while a profiler records;
    else one shared context manager that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name):
    """A decorator that runs the function, each call, in :func:`span`
    ``(name)``."""
    def decorate(f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            with span(name):
                return f(*args, **kwargs)
        return run
    return decorate


def count(name, value, times=1):
    """Add ``value`` (a host int, or a tensor whose elements are summed),
    ``times`` over, to the counter ``name`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        _counters.setdefault(name, []).append((value, times))


def counters():
    """{name: int}: each counter's total since :func:`reset_counters`."""
    return {name: sum(int(v.sum()) * k if isinstance(v, torch.Tensor)
                      else int(v) * k for v, k in parts)
            for name, parts in list(_counters.items())}


def reset_counters():
    """Clear every counter."""
    _counters.clear()
