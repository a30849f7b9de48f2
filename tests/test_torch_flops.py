"""The port's FLOP model (``graphdot_tpu_torch.util.flops``) against the JAX
package's: ``matvec_flops``, ``graph_dims`` and the ``useful`` count of a
Gram equal to JAX's; the kernels' ``executed`` count by hand; the H100
peaks and the error for an unknown card; the iteration-stats cache."""
import pytest

torch = pytest.importorskip('torch')

from graphdot_tpu import microkernel as jmk  # noqa: E402
from graphdot_tpu import testing as jax_testing  # noqa: E402
from graphdot_tpu.inference import GramFactory as JaxGramFactory  # noqa
from graphdot_tpu.kernel import MarginalizedGraphKernel as JaxMGK  # noqa
from graphdot_tpu.util import flops as jax_flops  # noqa: E402

from graphdot_tpu_torch import microkernel as tmk  # noqa: E402
from graphdot_tpu_torch import testing as port_testing  # noqa: E402
from graphdot_tpu_torch.inference import GramFactory  # noqa: E402
from graphdot_tpu_torch.kernel import MarginalizedGraphKernel  # noqa: E402
from graphdot_tpu_torch.util import flops  # noqa: E402

SET = (0, 8, (5, 9))


def test_matvec_flops_and_graph_dims_match_jax():
    for dims in [(1, 1, 1, 1), (10, 14, 5, 7), (346, 200, 23, 17)]:
        assert flops.matvec_flops(*dims) == jax_flops.matvec_flops(*dims)
    ours = port_testing.random_molecule_set(42, 6, (9, 24))
    theirs = jax_testing.random_molecule_set(42, 6, (9, 24))
    assert [flops.graph_dims(g) for g in ours] == \
        [jax_flops.graph_dims(g) for g in theirs]


@pytest.mark.parametrize('backend', ['cuda', 'edge'])
def test_useful_flops_match_jax(backend, tmp_path):
    graphs = port_testing.random_molecule_set(*SET)
    port = GramFactory(MarginalizedGraphKernel(
        tmk.TensorProduct(element=tmk.KroneckerDelta(0.2)),
        tmk.TensorProduct(length=tmk.SquareExponential(0.3)), q=0.05,
        backend=backend, device='cpu'), graphs)
    jax_factory = JaxGramFactory(JaxMGK(
        jmk.TensorProduct(element=jmk.KroneckerDelta(0.2)),
        jmk.TensorProduct(length=jmk.SquareExponential(0.3)), q=0.05,
        backend='edge'), jax_testing.random_molecule_set(*SET),
        union=False)
    theta = port.theta0
    want = jax_flops.gram_flop_report(jax_factory, theta)
    # on JAX's step counts the two models count the same
    same = flops.gram_flop_report(port, theta, stats=want['stats'])
    assert same['useful_flops'] == want['useful_flops'] > 0
    # on the port's own counts, each pair within one step of JAX's
    got = flops.gram_flop_report(port, theta)
    dims = [flops.graph_dims(g) for g in graphs]
    one_step = sum(flops.matvec_flops(dims[a][1], dims[b][1], dims[a][0],
                                      dims[b][0])
                   for grp in got['stats']
                   for a, b in zip(grp['gi'], grp['gj']))
    assert abs(got['useful_flops'] - want['useful_flops']) <= one_step
    if backend != 'cuda':
        assert got['executed_flops'] is None
        return
    executed = 0.0
    for grp in got['stats']:
        for it, a, b in zip(grp['iters'], grp['gi'], grp['gj']):
            (n1, m1), (n2, m2) = dims[a], dims[b]
            executed += float(it) * (2 * m1 * m2 + 15 * n1 * n2)
    assert got['executed_flops'] == executed
    path = tmp_path / 'stats.npz'
    flops.save_iteration_stats(path, got['stats'])
    again = flops.gram_flop_report(port, theta,
                                   stats=flops.load_iteration_stats(path))
    assert again['useful_flops'] == got['useful_flops']
    assert again['executed_flops'] == got['executed_flops']


def test_device_peaks():
    assert flops.device_peak_flops('NVIDIA H100 80GB HBM3') == 67e12
    assert set(flops.PEAK_FLOPS) >= {'NVIDIA H100 80GB HBM3',
                                     'NVIDIA H100 PCIe', 'NVIDIA H100 NVL'}
    with pytest.raises(KeyError):
        flops.device_peak_flops('TPU v5 lite')
