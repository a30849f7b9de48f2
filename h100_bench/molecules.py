"""QM7-like molecules from a seed: a vectorised copy of the recipe of
``scripts/make_qm7_fixture.py``.

The recipe: up to 7 heavy atoms of C, N, O and S in a random spanning tree
with one ring closure at times, saturated with hydrogens (so at most 23
atoms, as in QM7); a geometry relaxed by 800 steps of gradient descent
under harmonic bonds at the sums of covalent radii and a soft-core
repulsion of the non-bonded pairs; an atomization energy of minus the
bond enthalpies plus the residual strain, in kcal/mol.

Where it differs from the original:

- the sizes are not drawn a molecule at a time. A set of n molecules has
  the (heavy atoms, atoms) of a template: the recipe's molecules at the
  fixed seed :data:`TEMPLATE_SEED`, with the heavy-atom counts of a
  histogram that the configuration gives (the original draws 2 to 7
  equally often), apportioned to n by largest remainders. A seed orders
  the template and draws each molecule from the recipe until one of its
  slot's size comes, so that every seed makes the same amount of work;
- all molecules relax together on one device, each padded to the largest
  atom count, through dense pair matrices (the original loops over bonds
  and pairs); the random start is drawn from a ``torch.Generator`` on that
  device, seeded from the seed, where the original draws it from numpy. A
  seed gives the same molecules on the same device, not the original's.

The valence graphs are drawn as the original draws them, from
``numpy.random.default_rng([seed, stream])``.
"""
import numpy as np
import torch

VALENCE = {1: 1, 6: 4, 7: 3, 8: 2, 16: 2}
COVALENT_R = {1: 0.31, 6: 0.76, 7: 0.71, 8: 0.66, 16: 1.05}
#: mean single-bond enthalpies, kcal/mol (standard tables)
BOND_KCAL = {
    (1, 1): 104, (1, 6): 99, (1, 7): 93, (1, 8): 111, (1, 16): 87,
    (6, 6): 83, (6, 7): 73, (6, 8): 86, (6, 16): 65,
    (7, 7): 39, (7, 8): 48, (7, 16): 55,
    (8, 8): 35, (8, 16): 62, (16, 16): 54,
}
TEMPLATE_SEED = 0
#: draws of the recipe for one slot of the template before it takes the last
TRIES = 10000
RELAX_STEPS = 800
RELAX_LR = 0.02
#: range of the soft-core repulsion, Angstrom
REPULSION_RANGE = 2.2


def valence_graph(rng, n_heavy):
    """A random connected heavy-atom tree (with one ring closure at times)
    whose free valences are saturated by hydrogens; (numbers, bonds), as
    the original's ``random_valence_graph``."""
    heavy = rng.choice([6, 6, 6, 7, 8, 16], size=n_heavy,
                       p=[0.3, 0.3, 0.15, 0.12, 0.08, 0.05])
    numbers = [int(z) for z in heavy]
    free = [VALENCE[z] for z in numbers]
    bonds = []
    for i in range(1, n_heavy):
        parents = [j for j in range(i) if free[j] > 0]
        if not parents:
            break
        j = int(rng.choice(parents))
        bonds.append((j, i))
        free[j] -= 1
        free[i] -= 1
    if n_heavy >= 4 and rng.random() < 0.4:
        open_pairs = [
            (a, b) for a in range(n_heavy) for b in range(a + 2, n_heavy)
            if free[a] > 0 and free[b] > 0 and (a, b) not in bonds
        ]
        if open_pairs:
            a, b = open_pairs[int(rng.integers(len(open_pairs)))]
            bonds.append((a, b))
            free[a] -= 1
            free[b] -= 1
    for i in range(n_heavy):
        for _ in range(free[i]):
            numbers.append(1)
            bonds.append((i, len(numbers) - 1))
    return np.array(numbers), bonds


def bond_energy(numbers, bonds):
    return float(sum(
        BOND_KCAL[(min(numbers[a], numbers[b]), max(numbers[a], numbers[b]))]
        for a, b in bonds))


def relax(topologies, seed, device):
    """Relax all molecules together; returns (numbers [B, A] int64, positions
    [B, A, 3] float64, strain [B] float64) on ``device``, A the largest atom
    count, numbers 0 beyond a molecule's atoms."""
    B = len(topologies)
    A = max(len(n) for n, _ in topologies)
    K = max(len(b) for _, b in topologies)
    numbers = np.zeros((B, A), dtype=np.int64)
    bond_a = np.zeros((B, K), dtype=np.int64)
    bond_b = np.zeros((B, K), dtype=np.int64)
    has_bond = np.zeros((B, K), dtype=bool)
    for m, (nums, bonds) in enumerate(topologies):
        numbers[m, :len(nums)] = nums
        for k, (a, b) in enumerate(bonds):
            bond_a[m, k], bond_b[m, k], has_bond[m, k] = a, b, True
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    opts = dict(dtype=torch.float64, device=device)
    pos = torch.randn(B, A, 3, generator=gen, **opts) * 0.5
    spread = torch.randn(B, K, 3, generator=gen, **opts) * 0.8
    numbers = torch.from_numpy(numbers).to(device)
    bond_a, bond_b, has_bond = (torch.from_numpy(a).to(device)
                                for a in (bond_a, bond_b, has_bond))
    rows = torch.arange(B, device=device)
    # the bonds in order, each child placed beside its parent
    for k in range(K):
        on = has_bond[:, k]
        placed = pos[rows, bond_a[:, k]] + spread[:, k]
        pos[rows[on], bond_b[on, k]] = placed[on]

    radius = torch.zeros(max(COVALENT_R) + 1, **opts)
    for z, r in COVALENT_R.items():
        radius[z] = r
    rad = radius[numbers]
    r0 = rad[:, :, None] + rad[:, None, :]
    bonded = torch.zeros(B, A, A, dtype=torch.bool, device=device)
    bonded[rows[:, None].expand(B, K)[has_bond], bond_a[has_bond],
           bond_b[has_bond]] = True
    bonded = bonded | bonded.transpose(1, 2)
    real = numbers > 0
    eye = torch.eye(A, dtype=torch.bool, device=device)
    apart = real[:, :, None] & real[:, None, :] & ~bonded & ~eye

    def distances(p):
        d = p[:, :, None, :] - p[:, None, :, :]
        return d, torch.sqrt((d * d).sum(-1)) + 1e-12

    for _ in range(RELAX_STEPS):
        d, dist = distances(pos)
        pull = torch.where(bonded, 2.0 * (dist - r0) / dist, 0.0)
        push = torch.where(apart & (dist < REPULSION_RANGE),
                           -4.0 * (REPULSION_RANGE - dist) / dist, 0.0)
        pos = pos - RELAX_LR * ((pull + push)[..., None] * d).sum(2)
    _, dist = distances(pos)
    dist = dist - 1e-12
    strain = 0.5 * torch.where(bonded, 23.0 * (dist - r0) ** 2, 0.0).sum(
        (1, 2))
    return numbers, pos, strain


def heavy_counts(n, histogram):
    """The heavy-atom counts of a set of n molecules, before the seed's
    order: ``histogram`` [[heavy atoms, count], ...] apportioned to n by
    largest remainders (ties to the larger molecule), in ascending order."""
    sizes = np.array([int(h) for h, _ in histogram])
    share = np.array([float(c) for _, c in histogram])
    share = share / share.sum() * n
    whole = np.floor(share).astype(int)
    rest = np.lexsort((-sizes, -(share - whole)))[:n - whole.sum()]
    whole[rest] += 1
    order = np.argsort(sizes)
    return np.repeat(sizes[order], whole[order])


def template(n, histogram):
    """The (heavy atoms, atoms) of the n molecules of every set."""
    rng = np.random.default_rng(TEMPLATE_SEED)
    return [(int(c), len(valence_graph(rng, int(c))[0]))
            for c in heavy_counts(n, histogram)]


def make_molecules(seed, n, device, histogram, stream=0):
    """n molecules from ``seed`` (and ``stream``, for a second set from
    one seed), their heavy-atom counts by ``histogram`` (see
    :func:`heavy_counts`); returns (graphs, energies): a list of graphs as
    :mod:`h100_bench.reference` holds them (node feature ``element``, edge
    feature ``length``) and a float64 array of their atomization energies,
    kcal/mol."""
    from .adjacency import molecule_edges
    rng = np.random.default_rng([int(seed), stream])
    topologies = []
    for slot in rng.permutation(template(n, histogram)):
        heavy, atoms = (int(v) for v in slot)
        for _ in range(TRIES):
            numbers, bonds = valence_graph(rng, heavy)
            if len(numbers) == atoms:
                break
        topologies.append((numbers, bonds))
    numbers, pos, strain = relax(topologies, int(rng.integers(2**62)),
                                 device)
    edges = molecule_edges(numbers, pos)
    strain = strain.cpu().numpy()
    graphs, energies = [], []
    for m, ((nums, bonds), (src, dst, w, length)) in enumerate(
            zip(topologies, edges)):
        graphs.append({'n': len(nums),
                       'node': {'element': nums.astype(np.int8)},
                       'src': src, 'dst': dst, 'w': w,
                       'edge': {'length': length}})
        energies.append(-(bond_energy(nums, bonds) - float(strain[m])))
    return graphs, np.array(energies)
