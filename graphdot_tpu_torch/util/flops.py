"""Analytic FLOP model of the MLGK solve; counterpart of
``graphdot_tpu/util/flops.py``.

Combined with measured per-pair CG step counts
(``GramFactory.iteration_stats``) it reports two totals for a Gram:

- ``useful``: algorithmic FLOPs at the true (unpadded) graph dimensions,
  the four contractions of the edge-factored matvec at each pair's CG
  steps, as the JAX module counts them: the work a perfect machine would
  do.
- ``executed``: the FLOPs of the card's kernels, ``csrc/pcg_block.cuh``
  (``pcg_resident``) and ``csrc/pcg_stream.cu``. Each pair runs its own CG
  to its own convergence, and a step is the gather matvec over the pair's
  live edges, one multiply-add for each (e1, e2) of the two edge lists (2
  m1 m2 FLOPs), and the CG's elementwise work on the n1 n2 product nodes
  (``CG_OPS_PER_ELEMENT`` a node: the diagonal term, Ap, the three dot
  products, x, r, z and p). Nothing is padded: no MXU tiles, no packing,
  no block of pairs that waits for its slowest member. The JAX module's
  ``executed`` counted the TPU kernel's padded MXU passes instead.

``useful / dt / peak`` is the utilization figure against
:func:`device_peak_flops`, the card's float32 peak outside the tensor
cores, where the kernels do their work.
"""
import numpy as np

#: float32 peak (FLOP/s) outside the tensor cores, by the name that
#: ``torch.cuda.get_device_name`` gives: NVIDIA H100 Tensor Core GPU
#: datasheet (FP32: 67 TFLOPS SXM5, 51 TFLOPS PCIe, 60 TFLOPS NVL).
PEAK_FLOPS = {
    'NVIDIA H100 80GB HBM3': 67e12,     # H100 SXM5
    'NVIDIA H100 PCIe': 51e12,
    'NVIDIA H100 NVL': 60e12,
}
#: float32 operations of a CG step per product-graph node, beside the
#: matvec's edge terms (as ``chip_smoke.py`` counts them for its bounds)
CG_OPS_PER_ELEMENT = 15


def device_peak_flops(device=None):
    """The float32 peak of a card (FLOP/s): ``device`` a CUDA device, its
    index, or its name (default: the current card). Raises ``KeyError`` for
    a card that is not in :data:`PEAK_FLOPS`."""
    if device is None or not isinstance(device, str) or \
            device.startswith('cuda'):
        import torch
        name = torch.cuda.get_device_name(device)
    else:
        name = device
    try:
        return PEAK_FLOPS[name]
    except KeyError:
        raise KeyError(f'no float32 peak known for the card {name!r}; '
                       f'known: {sorted(PEAK_FLOPS)}') from None


def matvec_flops(m1, m2, n1, n2):
    """FLOPs of one edge-factored product-graph matvec at the given
    dims: the four contractions G = D1 Y, H = G D2^T, U = S1^T (T o H),
    out = U S2 (2 FLOPs per MAC)."""
    return 2 * (m1 * n1 * n2 + m1 * m2 * n2 + n1 * m1 * m2
                + n1 * m2 * n2)


def kernel_step_flops(m1, m2, n1, n2):
    """FLOPs of one CG step of the card's kernels on a pair of n1 and n2
    nodes and m1 and m2 live directed edges: the gather matvec's multiply-
    adds over the live edge pairs and the step's elementwise work."""
    return 2 * m1 * m2 + CG_OPS_PER_ELEMENT * n1 * n2


def graph_dims(graph):
    """(n_nodes, n_directed_edges) of a Graph — the true dims of its
    side of a pair solve."""
    n = len(graph.nodes)
    i = np.asarray(graph.edges['!i'])
    j = np.asarray(graph.edges['!j'])
    m = int(2 * np.sum(i != j) + np.sum(i == j))
    return n, int(m)


def save_iteration_stats(path, stats):
    """Persist ``GramFactory.iteration_stats`` output to an .npz cache
    (iteration counts are deterministic for a fixed workload, theta and
    ftol)."""
    payload = {'n_groups': np.int64(len(stats))}
    for i, grp in enumerate(stats):
        for key in ('iters', 'gi', 'gj'):
            payload[f'g{i}_{key}'] = np.asarray(grp[key])
        payload[f'g{i}_dims'] = np.asarray(
            [grp['ca'], grp['cb'], grp['m1'], grp['m2'],
             grp['n_jobs'], grp.get('k1', 1), grp.get('k2', 1)])
    np.savez_compressed(path, **payload)


def load_iteration_stats(path):
    blob = np.load(path)
    stats = []
    for i in range(int(blob['n_groups'])):
        d = blob[f'g{i}_dims']
        ca, cb, m1, m2, n_jobs = d[:5]
        k1, k2 = (d[5], d[6]) if len(d) > 5 else (1, 1)
        stats.append({
            'ca': int(ca), 'cb': int(cb), 'm1': int(m1),
            'm2': int(m2), 'n_jobs': int(n_jobs),
            'k1': int(k1), 'k2': int(k2),
            'iters': blob[f'g{i}_iters'],
            'gi': blob[f'g{i}_gi'], 'gj': blob[f'g{i}_gj'],
        })
    return stats


def gram_flop_report(factory, theta, include_executed=True,
                     stats=None):
    """FLOP totals for one Gram build of ``factory`` at ``theta``.

    Returns a dict with ``useful_flops``, ``executed_flops`` (None when
    the kernels' model does not apply: a backend other than ``'cuda'``, or
    a group on the kron route), and the iteration stats used. Pass
    precomputed ``stats`` (e.g. from :func:`load_iteration_stats`) to skip
    the instrumented solves.
    """
    if getattr(factory, '_two', False):
        raise NotImplementedError(
            'gram_flop_report supports symmetric factories only')
    if stats is None:
        stats = factory.iteration_stats(theta)
    dims = [graph_dims(g) for g in factory.graphs]

    def _2d(a):
        a = np.asarray(a)
        return a[:, None] if a.ndim == 1 else a

    useful = 0.0
    executed = 0.0
    for grp in stats:
        gi2, gj2 = _2d(grp['gi']), _2d(grp['gj'])
        for s, it in enumerate(np.asarray(grp['iters'])):
            for a in gi2[s]:
                if a < 0:
                    continue
                for b in gj2[s]:
                    if b < 0:
                        continue
                    n1, m1 = dims[a]
                    n2, m2 = dims[b]
                    useful += float(it) * matvec_flops(m1, m2, n1, n2)
                    executed += float(it) * kernel_step_flops(m1, m2, n1,
                                                              n2)

    plan = factory._plan
    applies = include_executed and factory.kernel.backend.mode == 'cuda' \
        and all(plan.route(g) != 'kron' for g in plan.groups)
    return {
        'useful_flops': useful,
        'executed_flops': executed if applies else None,
        'stats': stats,
    }
