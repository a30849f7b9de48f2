"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins."""
from .pcg import (pcg_resident, pcg_resident_reference, pcg_stream,
                  pcg_stream_reference)

__all__ = ['pcg_resident', 'pcg_resident_reference', 'pcg_stream',
           'pcg_stream_reference']
