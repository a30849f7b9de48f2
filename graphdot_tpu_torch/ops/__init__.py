"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins."""
from .pcg import (group_pairs, pcg_cluster, pcg_cluster_reference,
                  pcg_packed, pcg_packed_reference, pcg_resident,
                  pcg_resident_reference, pcg_stream, pcg_stream_reference)

__all__ = ['group_pairs', 'pcg_cluster', 'pcg_cluster_reference',
           'pcg_packed', 'pcg_packed_reference', 'pcg_resident',
           'pcg_resident_reference', 'pcg_stream', 'pcg_stream_reference']
