"""Interatomic distance -> edge weight rules; a copy of
``graphdot_tpu/graph/adjacency/atomic.py`` (numpy only)."""
import re

import numpy as np

from ._ptable import get_length_scales
from .euclidean import CompactBell, Gaussian, Tent


class AtomicAdjacency:
    r"""Converts interatomic distances into edge weights using
    :math:`a(i, j) = w(\frac{\lVert\mathbf{r}_{ij}\rVert}{\sigma_{ij}})`,
    where :math:`w` is a shape function that decays with distance and
    :math:`\sigma_{ij} = \sqrt{\sigma_i \sigma_j}` is the pairwise length
    scale.

    Parameters
    ----------
    shape: str or callable
        'tent[n]', 'gaussian', or 'compactbell[a,b]' (e.g. 'compactbell4,2'),
        or any callable ``shape(d, length_scale)`` with a ``cutoff`` method.
    length_scale: str or float
        Name of the per-element length-scale table ('vdw_radius' by
        default), or a constant length scale in Angstrom.
    zoom: float
        Zooming factor multiplied onto the length scales.
    """

    def __init__(self, shape='tent1', length_scale='vdw_radius', zoom=1.0):
        if isinstance(shape, str):
            self.shape = self._parse_shape(shape)
        else:
            self.shape = shape

        if isinstance(length_scale, str):
            self.ltable = get_length_scales(length_scale)
        else:
            self.ltable = length_scale * np.ones(119)

        self.ltable = self.ltable * zoom

    _SHAPE_GRAMMAR = [
        (r'gaussian$', lambda m: Gaussian()),
        (r'tent(\d+)$', lambda m: Tent(ord=int(m.group(1)))),
        (r'compactbell(\d+),(\d+)$',
         lambda m: CompactBell(a=int(m.group(1)), b=int(m.group(2)))),
    ]

    @classmethod
    def _parse_shape(cls, shape):
        for pattern, build in cls._SHAPE_GRAMMAR:
            m = re.match(pattern, shape)
            if m:
                return build(m)
        raise ValueError(f'Unrecognizable adjacency shape: {shape}')

    def __call__(self, n1, n2, r):
        """Compute the adjacency weight between two atoms at distance r."""
        r1 = self.ltable[n1]
        r2 = self.ltable[n2]
        return self.shape(r, np.sqrt(r1 * r2))

    def cutoff(self, elements):
        max_length_scale = self.ltable[elements].max()
        return self.shape.cutoff(max_length_scale)
