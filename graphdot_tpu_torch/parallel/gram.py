"""Gram matrices with their pair jobs split over the ranks of a mesh;
counterpart of ``graphdot_tpu/parallel/gram.py``.

The job list of each size-class group of a factory's
:class:`~graphdot_tpu_torch.kernel.marginalized._kernel.JobPlan` is split
statically into equal contiguous blocks, one a rank (:func:`job_share`),
as the JAX module shards a group's padded job list over its mesh: every
rank works on every size class. A rank solves its block through the plan's
own chunk solve (``pcg_resident`` on the card, one launch a chunk); the
blocks come together by one ``all_gather`` a group, and the Gram is
assembled and normalized as ``GramFactory.gram`` does. The partition is a
pure function of the group, the rank and the number of ranks, so that one
process can compute every rank's share (:func:`share_groups`,
:func:`solve_share`, :func:`assemble`).

Where the port differs: each rank solves its share by the factory's plan,
where the JAX module runs ``GramFactory._group_ops_solve`` under
``shard_map``, and the one-hot incidences of the JAX factory do not exist
(the card's kernels gather over edge lists).
"""
import torch

_SLICED = ('pos', 'swap', 'l1', 'l2', 'rows', 'cols')


def job_share(n_jobs, rank, size):
    """[start, stop) of a group's ``n_jobs`` jobs that ``rank`` of ``size``
    solves: blocks of ceil(n_jobs / size) jobs in rank order, the last ones
    shorter or empty."""
    block = -(-n_jobs // size)
    return min(rank * block, n_jobs), min((rank + 1) * block, n_jobs)


def share_groups(factory, rank, size):
    """The factory's plan groups cut to the jobs of ``rank`` of ``size``:
    each a copy of the group whose job lists (``pos``, ``swap``, ``l1``,
    ``l2``, ``rows``, ``cols``) hold that rank's block only."""
    shares = []
    for grp in factory._plan.groups:
        start, stop = job_share(len(grp['pos']), rank, size)
        share = dict(grp)
        for key in _SLICED:
            share[key] = grp[key][start:stop]
        shares.append(share)
    return shares


def solve_share(factory, theta_log_active, shares, lmin=0):
    """The raw kernel values of each share's jobs at one vector of
    log-scale active hyperparameters: a list of [len(share's jobs)] float32
    tensors on the kernel's device, each share solved chunk by chunk
    through the plan's :meth:`~JobPlan.solve` at its group's ``maxiter``."""
    theta = factory.full_theta(theta_log_active)
    if theta.dim() != 1:
        raise ValueError('a sharded Gram takes one hyperparameter vector')
    values = []
    for share, grp in zip(shares, factory._plan.groups):
        if len(share['pos']) == 0:
            values.append(theta.new_zeros(0))
            continue
        values.append(torch.cat([r for r, _ in factory._plan.solve(
            theta, share, False, lmin,
            maxiter=factory._group_maxiter(grp))]))
    return values


def assemble(factory, values):
    """The Gram [n, n] from the raw values of every group's jobs in the
    plan's order (``values[g]`` [len(group g's jobs)]), normalized when the
    factory normalizes, as ``GramFactory.gram`` assembles it."""
    n = factory._n
    K = values[0].new_zeros(n, n)
    for grp, r in zip(factory._plan.groups, values):
        K[grp['rows'], grp['cols']] = r
        K[grp['cols'], grp['rows']] = r
    if factory.normalize:
        d = torch.sqrt(torch.diagonal(K))
        K = K / d[:, None] / d[None, :]
    return K


def sharded_gram_fn(factory, mesh, axis=None, lmin=0):
    """``theta_log_active -> K``: the Gram of a symmetric
    :class:`~graphdot_tpu_torch.inference.GramFactory` at one vector of
    log-scale active hyperparameters, its pair jobs split over the ranks
    along ``axis`` of ``mesh``; every rank returns the whole K [n, n] on
    its device.

    Parameters
    ----------
    factory: a symmetric GramFactory, the same on every rank (its kernel's
        device is the rank's).
    mesh: :class:`~.mesh.Mesh`.
    axis: None | str | tuple of str
        Mesh axes to split the jobs over. None uses every axis.
    lmin: 0 or 1, as the kernel's.
    """
    if getattr(factory, '_two', False):
        raise NotImplementedError(
            'sharded_gram_fn supports symmetric factories only; shard '
            'a rectangular cross-Gram by splitting the row graphs '
            'across factories instead.')
    size = mesh.axis_size(axis)
    rank = mesh.axis_index(axis)
    shares = share_groups(factory, rank, size)

    def gram(theta_log_active):
        local = solve_share(factory, theta_log_active, shares, lmin)
        values = []
        for grp, r in zip(factory._plan.groups, local):
            n_jobs = len(grp['pos'])
            block = -(-n_jobs // size)
            padded = r.new_zeros(block)
            padded[:len(r)] = r
            values.append(mesh.all_gather(padded, axis)[:n_jobs])
        return assemble(factory, values)

    gram.shares = shares
    return gram
