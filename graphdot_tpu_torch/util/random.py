"""Shared host-side RNG plumbing for the model layer; a copy of
``graphdot_tpu/util/random.py``."""
import numpy as np


def as_generator(random_state=None):
    """Coerce None / an int seed / a Generator into an
    ``np.random.Generator``."""
    if isinstance(random_state, np.random.Generator):
        return random_state
    if random_state is None:
        return np.random.default_rng()
    return np.random.Generator(np.random.PCG64(random_state))
