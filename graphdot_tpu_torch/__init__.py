"""GraphDot-TPU ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside :mod:`graphdot_tpu`, which stays the reference.
The port imports nothing of it: it carries its own copy of the host layer
(graphs, padded batches, synthetic data, hyperparameter trees), everything
that computes on tensors is torch, and the product-graph PCG solve runs in
hand-written CUDA kernels on the card: ``csrc/pcg_resident.cu`` for pairs
that fit a block's shared memory, ``csrc/pcg_stream.cu`` for larger ones,
and ``csrc/pcg_packed.cu`` for the hyperparameter gradient's tangent
systems, the n_theta systems of a pair as one group. On top of the
kernel sit the Gram factory, the Gaussian-process models, the samplers of
``inference``, the graph metrics of ``metric`` and ``experimental``,
molecular graphs from atoms (``Graph.from_ase``, ``dataset``), and the
multi-process layer of ``parallel`` over ``torch.distributed`` (Grams,
CG, chains and particles split over ranks, one device each).
"""
from .graph import Graph

__version__ = '0.3.0'
__all__ = ['Graph']
