"""Linear algebra helpers for the model layer; counterpart of
``graphdot_tpu/linalg``.

Every dense decomposition and product runs in float64 on an explicit
torch device, the card unless the caller asks for the CPU
(:mod:`._exec`): Cholesky factor-and-solve (:mod:`.cholesky`), the
conjugate-gradient solve (:mod:`.cg`), Hermitian matrix functions by an
eigendecomposition (:mod:`.spectral`) and factored low-rank algebra
(:mod:`.low_rank`). :mod:`.block`, the bordered rank-1 inverse update, is
a numpy copy."""
