"""Linear algebra helpers for the model layer; counterpart of
``graphdot_tpu/linalg``. Only :mod:`._exec` is ported so far."""
