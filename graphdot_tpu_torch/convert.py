"""Carry hyperparameters from a :mod:`graphdot_tpu` kernel to its port.

A JAX ``MarginalizedGraphKernel`` exposes its linear-scale hyperparameters
as ``flat_hyperparameters``, a numpy vector in the layout
``[p..., q, node..., edge...]``; the port's kernel has the same layout.
"""
import numpy as np

from .util.iterable import flatten, fold_like


def hyperparameters_from_numpy(kernel, flat_theta, bounds=None):
    """Set ``kernel``'s linear-scale hyperparameters from ``flat_theta``.

    Parameters
    ----------
    kernel: graphdot_tpu_torch MarginalizedGraphKernel
    flat_theta: 1-D array in the layout ``[p..., q, node..., edge...]``,
        e.g. a JAX kernel's ``flat_hyperparameters``.
    bounds: optional hyperparameter-bounds tree of the kernel the values
        come from (e.g. a JAX kernel's ``hyperparameter_bounds``); it must
        equal ``kernel.hyperparameter_bounds``.

    Raises ``ValueError`` on a length mismatch, on a bounds mismatch, and
    when a value that is not fixed lies outside its bounds.
    """
    flat = np.asarray(flat_theta, dtype=float).ravel()
    if flat.shape != (kernel.n_dims,):
        raise ValueError(
            f'{len(flat)} hyperparameters given; the kernel has '
            f'{kernel.n_dims}')
    own_bounds = kernel.hyperparameter_bounds
    if bounds is not None and list(flatten(bounds)) != list(
            flatten(own_bounds)):
        raise ValueError(
            f'bounds {bounds} differ from the kernel\'s {own_bounds}')
    lo, hi = kernel._bounds_table().T
    free = ~np.isnan(lo)
    outside = free & ((flat < lo) | (flat > hi))
    if outside.any():
        raise ValueError(
            f'hyperparameters {np.flatnonzero(outside).tolist()} lie '
            f'outside their bounds: {flat[outside]} not in '
            f'{list(zip(lo[outside], hi[outside]))}')
    (kernel.p.theta,
     kernel.q,
     kernel.node_kernel.theta,
     kernel.edge_kernel.theta
     ) = fold_like(flat, kernel.hyperparameters)
    return kernel
