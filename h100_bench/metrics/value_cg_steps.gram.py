"""CG steps a value system over the traced window: the program's counter
``cg_steps.value`` over ``cg_systems.value``, from the step counts that the
value solve's kernels return."""
from h100_bench.spans import counter_ratio

UNIT = 'steps'


def read(run):
    if run.trace is None:
        return None
    return counter_ratio('cg_steps.value', 'cg_systems.value')
