"""Checkpoint and resume of long MCMC runs; counterpart of
``graphdot_tpu/inference/checkpoint.py``, in the same ``.npz`` format, so
that a checkpoint written by either package loads in the other."""
import os

import numpy as np

from .diagnostics import _host

KEYS = ('samples', 'logp', 'accept_prob', 'divergent', 'step_size',
        'inv_mass')


def save_chains(path, out, extra=None):
    """Persist a sampler result dict (as returned by
    :func:`graphdot_tpu_torch.inference.sample`) plus optional metadata,
    through a temporary file replaced at the end."""
    payload = {k: _host(out[k]) for k in KEYS}
    if extra:
        for k, v in extra.items():
            payload['extra_' + k] = _host(v)
    tmp = path + '.tmp'
    np.savez_compressed(tmp, **payload)
    os.replace(tmp + '.npz' if os.path.exists(tmp + '.npz') else tmp,
               path)


def load_chains(path):
    """Load a checkpoint written by :func:`save_chains`; returns the
    result dict as numpy arrays (and metadata under 'extra')."""
    data = np.load(path, allow_pickle=False)
    out = {k: data[k] for k in KEYS if k in data}
    out['extra'] = {
        k[len('extra_'):]: data[k] for k in data.files
        if k.startswith('extra_')
    }
    return out


def resume_state(out):
    """The continuation inputs for :func:`sample` from a previous result:
    (init positions [n_chains, D], step_size, inv_mass)."""
    samples = _host(out['samples'])
    return (samples[:, -1, :], float(_host(out['step_size'])),
            _host(out['inv_mass']))
