"""Monte Carlo tree search over graph rewrites; a copy of
``graphdot_tpu/model/tree_search`` (numpy and scipy on the host)."""
from ._rewriter import AbstractRewriter, LookAheadSequenceRewriter
from .graph_transformer import MCTSGraphTransformer

__all__ = [
    'MCTSGraphTransformer', 'LookAheadSequenceRewriter', 'AbstractRewriter'
]
