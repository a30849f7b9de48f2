"""Graph container and padded batches, reused from :mod:`graphdot_tpu.graph`
(which loads no JAX)."""
from graphdot_tpu.graph import Graph
from graphdot_tpu.graph.batch import batch_graphs as _batch_graphs

__all__ = ['Graph', 'batch_graphs']


def batch_graphs(graphs, **kwargs):
    """:func:`graphdot_tpu.graph.batch.batch_graphs` on the numpy packer.

    The compiled native packer is left out: it is built for the host that
    compiled it (``-march=native``) and may not run on another CPU."""
    return _batch_graphs(graphs, use_native=False, **kwargs)
