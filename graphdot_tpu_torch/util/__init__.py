"""Host-side helpers: hyperparameter trees (:mod:`.pretty_tuple`,
:mod:`.iterable`) and the per-graph cache (:mod:`.cookie`). A copy of the
parts of :mod:`graphdot_tpu.util` that the port uses."""
