"""Several processes, one device each, over ``torch.distributed``: process
meshes, Grams with their pair jobs split over ranks, and row-sharded CG;
counterpart of ``graphdot_tpu/parallel``. The samplers split their chains
and particles over a mesh themselves (``inference.sample(mesh=...)``,
``inference.smc_sample(mesh=...)``)."""
from .gram import sharded_gram_fn
from .mesh import (Mesh, init_distributed, make_mesh, replicated,
                   sharded_along)
from .solve import sharded_cg_solve_fn, sharded_gp_solve

__all__ = [
    'make_mesh', 'replicated', 'sharded_along', 'sharded_gram_fn',
    'init_distributed', 'sharded_cg_solve_fn', 'sharded_gp_solve', 'Mesh',
]
