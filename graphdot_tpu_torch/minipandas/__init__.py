"""Alias module for API parity with the reference ``graphdot.minipandas``;
a copy of ``graphdot_tpu/minipandas`` over the port's ``graph/frame.py``."""
from ..graph.frame import DataFrame, Series

__all__ = ['DataFrame', 'Series']
