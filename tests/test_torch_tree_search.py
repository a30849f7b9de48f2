"""The port's tree search (``graphdot_tpu_torch.model.tree_search``, a copy
of the JAX package's) against the original, draw for draw, on the CPU.

The three rewriter tests of ``tests/test_active_learning.py`` and the MCTS
test of ``tests/test_models.py`` run in both packages from the same seeds:
the same offspring, proposals and errors from the rewriter, and the same
search tree and ranked frame from ``MCTSGraphTransformer.seek``.
"""
import numpy as np
import pytest

from graphdot_tpu.model.tree_search import (
    LookAheadSequenceRewriter as JaxRewriter,
    MCTSGraphTransformer as JaxMCTS)

from graphdot_tpu_torch.model.tree_search import (
    AbstractRewriter, LookAheadSequenceRewriter, MCTSGraphTransformer)


@pytest.mark.parametrize('seed', [0, 1, 7])
def test_sequence_rewriter_matches_jax(seed):
    train = ['abab', 'baba', 'abba', 'aabb']
    got, want = [], []
    for cls, out in ((LookAheadSequenceRewriter, got), (JaxRewriter, want)):
        rw = cls(n=2, b=4, random_state=seed)
        rw.fit(train)
        for s in ('abab', 'ba', '', 'aabbab'):
            out.append(sorted(rw(s)))
    assert got == want
    for offspring in got[:1]:
        assert 0 < len(offspring) <= 4
        assert all(t != 'abab' and set(t) <= {'a', 'b'} for t in offspring)


def test_sequence_rewriter_context_matches_jax():
    draws = []
    for cls in (LookAheadSequenceRewriter, JaxRewriter):
        rw = cls(n=1, b=8, p_insert=1, p_mutate=0, p_delete=0,
                 random_state=0)
        rw.fit(['axaxax', 'axax'])
        draws.append([rw._propose('ax', 1) for _ in range(20)]
                     + [rw._propose('xa', k) for k in range(3)])
    assert draws[0] == draws[1]
    assert set(draws[0][:20]) == {'x'}


def test_rewriter_unfit_raises():
    rw = LookAheadSequenceRewriter()
    assert isinstance(rw, AbstractRewriter)
    with pytest.raises(RuntimeError):
        rw.tree


class ExactSurrogate:
    """The surrogate of ``tests/test_models.py``'s MCTS test: the value of
    an integer 'graph', with variance 0.25."""

    def predict(self, X, return_cov=False):
        mean = np.asarray([float(g) for g in X])
        cov = np.eye(len(mean)) * 0.25
        return (mean, cov) if return_cov else mean


def rewriter(node, rng):
    g = int(node.g)
    return [g - 1, g + 1, g + rng.integers(-2, 3)]


@pytest.mark.parametrize('seed', [42, 0])
def test_mcts_seek_matches_jax(seed):
    frames = []
    for cls in (MCTSGraphTransformer, JaxMCTS):
        mcts = cls(rewriter=rewriter, surrogate=ExactSurrogate(),
                   exploration_bias=1.0, precision=0.1)
        frames.append(mcts.seek(g0=0, target=3.0, maxiter=120,
                                random_state=seed))
    got, want = frames
    assert list(got.columns) == list(want.columns)
    assert list(got.index) == list(want.index)
    for col in want.columns:
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      want[col].to_numpy(), err_msg=col)
    assert abs(got.g.iloc[0] - 3.0) <= 1.0
    assert (got.likelihood.values[:-1] >= got.likelihood.values[1:]).all()


def test_mcts_tree_matches_jax():
    trees = []
    for cls in (MCTSGraphTransformer, JaxMCTS):
        mcts = cls(rewriter=rewriter, surrogate=ExactSurrogate(),
                   exploration_bias=1.0, precision=0.1)
        trees.append(mcts.seek(g0=0, target=3.0, maxiter=10,
                               return_tree=True, random_state=0))
    got, want = (t.flat for t in trees)
    assert trees[0].children[0] is not None and len(got) > 10
    assert list(got.columns) == list(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(np.asarray(got[col]),
                                      np.asarray(want[col]), err_msg=col)
    assert str(trees[0]) == str(trees[1])
