"""Process meshes over ``torch.distributed``; counterpart of
``graphdot_tpu/parallel/mesh.py``.

A :class:`Mesh` names axes over the ranks of the process group, as a JAX
mesh names them over devices: the two axes of the JAX package are
``'pairs'`` (graph-pair jobs of a Gram) and ``'chains'`` (MCMC chains, SMC
particles). Each rank is one process with one device: ``cuda:{local_rank}``
over NCCL, or the CPU over gloo when the caller asks for it. Without a
process group a mesh has one rank, and its collectives return their input.
"""
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device='cuda', local_rank=None):
    """Start this process's rank of the process group: NCCL when ``device``
    is CUDA, gloo when it is the CPU. Does nothing when a group exists.

    Parameters
    ----------
    coordinator_address: ``'host:port'`` or a ``torch.distributed`` init
        method (``'tcp://host:port'``, ``'file://...'``); None reads
        ``MASTER_ADDR`` and ``MASTER_PORT`` (``'env://'``).
    num_processes, process_id: the world size and this process's rank
        (None: ``WORLD_SIZE`` and ``RANK`` of the environment).
    device: ``'cuda'`` or ``'cpu'``.
    local_rank: this rank's card on its host (default: ``LOCAL_RANK`` of
        the environment, else the rank); the rank's device becomes
        ``cuda:{local_rank}``. A CUDA device without a card raises, and
        nothing falls back to gloo or to the CPU.

    Returns
    -------
    The rank's device.
    """
    device = torch.device(device)
    if dist.is_initialized():
        return _rank_device(device, local_rank)
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f'tcp://{coordinator_address}'
    if num_processes is None:
        num_processes = int(os.environ['WORLD_SIZE'])
    if process_id is None:
        process_id = int(os.environ['RANK'])
    if local_rank is None:
        local_rank = int(os.environ.get('LOCAL_RANK', process_id))
    rank_device = _rank_device(device, local_rank)
    if rank_device.type == 'cuda':
        if not torch.cuda.is_available() \
                or local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f'init_distributed: no CUDA device {rank_device} for the '
                'NCCL rank')
        torch.cuda.set_device(rank_device)
        backend = 'nccl'
    else:
        backend = 'gloo'
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return rank_device


def _rank_device(device, local_rank):
    if device.type != 'cuda':
        return device
    if local_rank is None:
        local_rank = int(os.environ.get(
            'LOCAL_RANK', dist.get_rank() if dist.is_initialized() else 0))
    return torch.device('cuda', local_rank)


class Mesh:
    """Named axes over the ranks of the process group: ``ranks`` an integer
    array of the world's ranks in the axes' shape, ``axis_names`` their
    names. :meth:`group` gives the process group along some axes, and
    :meth:`all_gather` and :meth:`all_reduce` run over it."""

    def __init__(self, ranks, axis_names):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        assert self.ranks.ndim == len(self.axis_names)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self._groups = {}

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.ranks.shape))

    def _axes(self, axes):
        if axes is None:
            return self.axis_names
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def axis_size(self, axes=None):
        """Ranks along ``axes`` (a name, a tuple of names, or None: all)."""
        return int(np.prod([self.shape[a] for a in self._axes(axes)]))

    def axis_index(self, axes=None):
        """This rank's place along ``axes``, the axes taken row-major in
        the order given."""
        coords = dict(zip(self.axis_names, (int(c) for c in np.argwhere(
            self.ranks == self.rank)[0])))
        index = 0
        for a in self._axes(axes):
            index = index * self.shape[a] + coords[a]
        return index

    def _members(self, axes):
        """The rank lists of every group along ``axes``, each in the order
        of :meth:`axis_index`."""
        axes = self._axes(axes)
        moved = np.moveaxis(
            self.ranks, [self.axis_names.index(a) for a in axes],
            range(self.ranks.ndim - len(axes), self.ranks.ndim))
        return moved.reshape(-1, self.axis_size(axes))

    def group(self, axes=None):
        """The process group of the ranks that differ from this one along
        ``axes`` only: None (the world's group) when it is the whole world.
        Every rank must call it for the same axes in the same order, since
        it creates groups."""
        axes = self._axes(axes)
        if axes not in self._groups:
            members = self._members(axes)
            if members.shape[1] == dist.get_world_size():
                self._groups[axes] = None
            else:
                found = None
                for ranks in members:
                    g = dist.new_group([int(r) for r in ranks])
                    if self.rank in ranks:
                        found = g
                self._groups[axes] = found
        return self._groups[axes]

    def _local(self, axes):
        """Whether a collective along ``axes`` is this rank alone: one rank
        along them, in a world of more ranks or without a process group (a
        process group of one rank runs its collectives through its
        backend)."""
        return self.axis_size(axes) == 1 and not (
            dist.is_initialized() and dist.get_world_size() == 1)

    def all_gather(self, t, axes=None, dim=0):
        """The tensors ``t`` of the ranks along ``axes``, concatenated along
        ``dim`` in the order of :meth:`axis_index`; each rank's ``t`` has
        the same shape."""
        if self._local(axes):
            return t
        size = self.axis_size(axes)
        flag = t.dtype == torch.bool        # sent as bytes
        t = (t.to(torch.uint8) if flag else t).contiguous()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=self.group(axes))
        out = torch.cat(parts, dim=dim)
        return out.bool() if flag else out

    def all_reduce(self, t, axes=None):
        """The sum of ``t`` over the ranks along ``axes``, a new tensor."""
        if self._local(axes):
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.group(axes))
        return t


def make_mesh(axes=None):
    """A mesh over the world's ranks.

    Parameters
    ----------
    axes: dict name -> size, with at most one -1 (inferred), or None for a
        1-D ``{'pairs': world_size}`` mesh. The sizes must cover the world.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if axes is None:
        axes = {'pairs': n}
    names = list(axes.keys())
    sizes = list(axes.values())
    n_infer = sizes.count(-1)
    assert n_infer <= 1
    if n_infer:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    assert int(np.prod(sizes)) == n, (
        f'Mesh axes {dict(zip(names, sizes))} do not cover {n} ranks.'
    )
    return Mesh(np.arange(n).reshape(sizes), names)


class Sharding(NamedTuple):
    """How a tensor lies over a mesh: dimension ``dim`` split in equal
    contiguous blocks over the ranks along ``axes`` (None: every rank
    holds all of it)."""
    mesh: Mesh
    axes: tuple = None
    dim: int = 0

    def bounds(self, n):
        """This rank's [start, stop) of a dimension of size n, which the
        ranks along the axes must divide."""
        if self.axes is None:
            return 0, n
        size = self.mesh.axis_size(self.axes)
        assert n % size == 0, (
            f'{n} rows do not split over the {size} ranks of {self.axes}')
        block = n // size
        start = self.mesh.axis_index(self.axes) * block
        return start, start + block

    def local(self, t):
        """This rank's block of ``t``, which every rank holds whole."""
        start, stop = self.bounds(t.shape[self.dim])
        return t.narrow(self.dim, start, stop - start)

    def gather(self, t):
        """The whole tensor from each rank's block ``t``."""
        if self.axes is None:
            return t
        return self.mesh.all_gather(t, self.axes, self.dim)


def replicated(mesh):
    """Every rank holds the whole tensor."""
    return Sharding(mesh, None, 0)


def sharded_along(mesh, axis, ndim=1):
    """The leading dimension split over ``axis`` (a name or a tuple of
    names); ``ndim`` is kept for the JAX signature (the other dimensions
    are whole on every rank)."""
    del ndim
    return Sharding(mesh, (axis,) if isinstance(axis, str) else tuple(axis),
                    0)
