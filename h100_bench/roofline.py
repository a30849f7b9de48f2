"""The card's peaks and the bytes and operations of the solve layers, from
the graphs' unpadded sizes: the yardstick of the ``roofline.*`` metrics.

A frozen copy of the arithmetic of ``graphdot_tpu_torch/util/flops.py``
(``PEAK_FLOPS``, ``kernel_step_flops``: a CG step of a pair of n1 and n2
nodes and m1 and m2 directed edges is 2 m1 m2 operations for the product
over the live edge pairs and :data:`CG_OPS_PER_ELEMENT` a product node)
and of ``chip_smoke.py``'s bound (``HBM_BYTES_PER_S``).

Where it differs: the bytes are counted from the unpadded sizes, not from
the operands that a kernel was handed, so that neither padding nor a change
of route moves them. A value solve reads T's live m1 m2 entries, its edge
lists, and three product-node vectors (the diagonal, the preconditioner and
b), and writes x; a pair's k tangent systems read T and the edge lists
once, the two vectors and k right-hand sides, and write k solutions. All
are float32 (4 bytes), the edge lists int32. The steps are those that the
benchmark's float64 reference takes to the program's stopping rule (the
residual's norm below tol n1 n2), counted on a seeded sample of the pairs
(:func:`estimate`).
"""
import numpy as np

#: HBM3 bytes/s of an H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = {'NVIDIA H100 80GB HBM3': 3.35e12}
#: float32 operations/s outside the tensor cores (NVIDIA's data sheet)
PEAK_FLOPS = {'NVIDIA H100 80GB HBM3': 67e12}
#: float32 operations of a CG step per product node, beside the product:
#: the diagonal term, Ap, pAp, x, r, z, rz, r.r and p
CG_OPS_PER_ELEMENT = 15


def peaks(device_name):
    """(bytes/s, operations/s) of a card by the name
    ``torch.cuda.get_device_name`` gives; raises KeyError for another."""
    return HBM_BYTES_PER_S[device_name], PEAK_FLOPS[device_name]


def step_ops(n1, m1, n2, m2):
    """Operations of one CG step of a pair (arrays broadcast)."""
    return 2.0 * m1 * m2 + CG_OPS_PER_ELEMENT * n1 * n2


def value_bytes(n1, m1, n2, m2):
    """Bytes a value solve of a pair must move at least."""
    return 4.0 * m1 * m2 + 8.0 * (m1 + m2) + 4.0 * 4 * n1 * n2


def tangent_bytes(n1, m1, n2, m2, k):
    """Bytes the k tangent solves of a pair must move at least."""
    return 4.0 * m1 * m2 + 8.0 * (m1 + m2) + 4.0 * (2 + 2 * k) * n1 * n2


def least_seconds(total_bytes, total_ops, device_name):
    """(seconds, 'bytes' or 'operations'): the least time of the work on
    the card, the larger of its two bounds."""
    bw, fl = peaks(device_name)
    by_bytes, by_ops = total_bytes / bw, total_ops / fl
    return (by_bytes, 'bytes') if by_bytes >= by_ops else (by_ops,
                                                          'operations')


def estimate(sizes1, sizes2, pairs, sample, steps):
    """Total operations of a solve over ``pairs`` [P, 2] of graphs with
    (n, m directed) ``sizes1`` and ``sizes2`` [G, 2], from the steps
    counted on the positions ``sample``: the ratio estimate
    ``sum(ops a step) * sum_sample(ops a step * steps) /
    sum_sample(ops a step)``; exact where the sample is every pair."""
    n1, m1 = sizes1[pairs[:, 0]].T
    n2, m2 = sizes2[pairs[:, 1]].T
    per_step = step_ops(n1, m1, n2, m2)
    s = per_step[sample]
    return float(per_step.sum() * (s * steps).sum() / s.sum())


def graph_sizes(graphs):
    """[G, 2] float array of (nodes, directed edges) of each graph."""
    return np.array([(g['n'], 2 * len(g['src'])) for g in graphs],
                    dtype=float)
