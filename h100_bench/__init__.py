"""The H100 benchmark of ``graphdot_tpu_torch``.

``run.py`` runs one cell of ``BENCHMARK.json`` once. The cell's
configuration (``configs/``), traffic mix (``traffic/``) and metrics
(``metrics/``) are files found by name. The generators of the inputs, the
plain reference that decides ``correct``, the byte and operation counts of
the roofline shares and the card's peaks live here too, so that a change to
the program cannot move them. Nothing here imports JAX or the JAX package.
"""
