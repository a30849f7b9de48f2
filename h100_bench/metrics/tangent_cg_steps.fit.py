"""CG steps a tangent system over the traced window: the program's counter
``cg_steps.tangent`` over ``cg_systems.tangent``, from the step counts that
the tangent solve's kernels return (a packed group's steps once for each
member it carries)."""
from h100_bench.spans import counter_ratio

UNIT = 'steps'


def read(run):
    if run.trace is None:
        return None
    return counter_ratio('cg_steps.tangent', 'cg_systems.tangent')
