"""The port's copy of the paper's algebra against the JAX package's, on the CPU.

``repro_torch.core.{groups,homomorphism,solver,hexarray}`` are copies of
``repro.core``'s modules (neither imports JAX), so every answer must be
equal, exactly: the solver's solutions in the same order with the same hop
costs, movements and Cannon flags; Lemmas 3 and 5, the homomorphism checks,
the wreath-tree group and Sigma_q; the hex array's systolic properties and
its simulation, bitwise, on integer matrices.  Random inputs come from
``numpy.random.default_rng``.
"""
import itertools

import numpy as np
import pytest

from repro.core import groups as ref_groups
from repro.core import hexarray as ref_hex
from repro.core import homomorphism as ref_hom
from repro.core import solver as ref_solver
from repro_torch.core import groups, hexarray, homomorphism, solver

QS = (2, 3, 4, 5)


def _solution(s, mod):
    return (s.schedule.q, s.schedule.t, s.schedule.M, s.schedule.anchor, s.hop_cost,
            s.movements, s.stationary_vars, mod.is_cannon_like(s))


@pytest.mark.parametrize("q", QS)
def test_solve_torus_same_solutions_in_same_order(q):
    port = [_solution(s, solver) for s in solver.solve_torus(q)]
    ref = [_solution(s, ref_solver) for s in ref_solver.solve_torus(q)]
    assert port == ref and port
    assert solver.minimal_hop_cost(q) == ref_solver.minimal_hop_cost(q) == 2


@pytest.mark.parametrize("q,kw", [(3, dict(require_stationary="C")),
                                  (4, dict(window=(0, 1), max_solutions=7)),
                                  (5, dict(require_stationary="A", max_solutions=3))])
def test_solve_torus_options_agree(q, kw):
    assert ([_solution(s, solver) for s in solver.solve_torus(q, **kw)]
            == [_solution(s, ref_solver) for s in ref_solver.solve_torus(q, **kw)])


@pytest.mark.parametrize("q", (2, 3, 4))
def test_at_most_one_stationary_agrees(q):
    assert solver.at_most_one_stationary(q) == ref_solver.at_most_one_stationary(q) is True


def _perms(q):
    return [tuple(p) for p in itertools.permutations(range(q))]


@pytest.mark.parametrize("q", (3, 4, 5))
def test_permutations_and_lemma3(q):
    """Every permutation of S_q: order, cycle type, primitivity, inverse,
    the homomorphism test to Z/qZ for every image, and Lemma 3."""
    for img in _perms(q):
        p, r = groups.Permutation(img), ref_groups.Permutation(img)
        assert (p.order(), p.cycle_type(), p.is_primitive(), p.inverse().image,
                p.power(3).image) == (r.order(), r.cycle_type(), r.is_primitive(),
                                      r.inverse().image, r.power(3).image)
        for image in range(q):
            assert (homomorphism.hom_exists_perm_to_cyclic(p, q, image)
                    == ref_hom.hom_exists_perm_to_cyclic(r, q, image))
        assert (homomorphism.lemma3_imprimitive_in_kernel(p, q)
                == ref_hom.lemma3_imprimitive_in_kernel(r, q))


def test_lemma5_and_primes():
    for q in range(2, 12):
        for t in range(1, 30):
            assert homomorphism.lemma5_q_divides_t(q, t) == ref_hom.lemma5_q_divides_t(q, t)
    assert ([n for n in range(60) if homomorphism.is_prime(n)]
            == [n for n in range(60) if ref_hom.is_prime(n)])


@pytest.mark.parametrize("seed", range(4))
def test_abelian_hom_and_verify_hom_property(seed):
    """Generator-image homomorphisms into (Z/6)^2: well-definedness, images,
    image size, and ``verify_hom_property`` on the same samples."""
    rng = np.random.default_rng(seed)
    orders = tuple(int(o) for o in rng.choice([2, 3, 4, 6], size=2))
    images = tuple(tuple(int(v) for v in rng.integers(0, 6, size=2)) for _ in orders)
    port = homomorphism.AbelianHom(orders, groups.ProductGroup((6, 6)), images)
    ref = ref_hom.AbelianHom(orders, ref_groups.ProductGroup((6, 6)), images)
    assert port.is_well_defined() == ref.is_well_defined()
    assert port.image_size() == ref.image_size()
    samples = [tuple(int(v) for v in rng.integers(0, 12, size=2)) for _ in range(6)]
    for e in samples:
        assert port.apply(e) == ref.apply(e)
    add_src = lambda a, b: tuple(x + y for x, y in zip(a, b))  # noqa: E731
    # apply is linear in the exponents, so both checks pass it
    assert (homomorphism.verify_hom_property(port.apply, add_src,
                                             groups.ProductGroup((6, 6)).add, samples)
            is ref_hom.verify_hom_property(ref.apply, add_src,
                                           ref_groups.ProductGroup((6, 6)).add, samples)
            is True)
    # a map that is not a homomorphism fails both checks alike
    bad = lambda e: ((e[0] * e[0]) % 6, e[1] % 6)  # noqa: E731
    assert (homomorphism.verify_hom_property(bad, add_src, groups.ProductGroup((6, 6)).add,
                                             samples)
            == ref_hom.verify_hom_property(bad, add_src, ref_groups.ProductGroup((6, 6)).add,
                                           samples))


@pytest.mark.parametrize("q", (2, 3, 5, 7))
def test_cyclic_groups_and_sigma_subgroup(q):
    assert ([p.image for p in groups.sigma_subgroup(q)]
            == [p.image for p in ref_groups.sigma_subgroup(q)])
    c, rc = groups.CyclicGroup(q), ref_groups.CyclicGroup(q)
    assert [c.order_of(a) for a in range(q)] == [rc.order_of(a) for a in range(q)]
    g, rg = groups.ProductGroup((q, 2 * q)), ref_groups.ProductGroup((q, 2 * q))
    assert ([g.order_of(e) for e in g.elements()] == [rg.order_of(e) for e in rg.elements()])


@pytest.mark.parametrize("k", (1, 2, 3, 4))
def test_wreath_tree_group(k):
    """|S2 wr k|, and random elements' actions, compositions and table
    round trips."""
    assert groups.fat_tree_group_size(k) == ref_groups.fat_tree_group_size(k)
    rng = np.random.default_rng(k)

    def draw():
        return tuple(tuple(int(b) for b in rng.integers(0, 2, size=2 ** (k - lvl)))
                     for lvl in range(1, k + 1))

    for _ in range(8):
        sa, sb = draw(), draw()
        a, b = groups.WreathTreeElement(k, sa), groups.WreathTreeElement(k, sb)
        ra, rb = ref_groups.WreathTreeElement(k, sa), ref_groups.WreathTreeElement(k, sb)
        assert [a.apply(i) for i in range(2 ** k)] == [ra.apply(i) for i in range(2 ** k)]
        assert a.compose(b).swaps == ra.compose(rb).swaps
        table = tuple(a.apply(i) for i in range(2 ** k))
        assert (groups.WreathTreeElement.from_table(k, table).swaps
                == ref_groups.WreathTreeElement.from_table(k, table).swaps == sa)


def test_hex_lattice_link_hops():
    lat, ref = groups.HexLattice(), ref_groups.HexLattice()
    for x in range(-4, 5):
        for y in range(-4, 5):
            assert lat.link_hops((x, y)) == ref.link_hops((x, y))
            assert lat.combine(x, y) == ref.combine(x, y)


@pytest.mark.parametrize("q", (2, 3, 4))
def test_hex_schedule_properties_and_simulation(q):
    """Systolic properties, the map f, the streams' movements, and the
    simulation bitwise on integer matrices."""
    port, ref = hexarray.HexSchedule(q), ref_hex.HexSchedule(q)
    assert port.systolic_properties() == ref.systolic_properties()
    assert all(port.systolic_properties().values())
    assert port.movement_vectors() == ref.movement_vectors()
    assert port.num_steps == ref.num_steps == 3 * q - 2
    for ijk in itertools.product(range(q), repeat=3):
        assert port.f(*ijk) == ref.f(*ijk)
    rng = np.random.default_rng(0)
    a = rng.integers(-50, 50, size=(q, q))
    b = rng.integers(-50, 50, size=(q, q))
    got, want = port.simulate(a, b), ref.simulate(a, b)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, port.reference(a, b))
    assert np.array_equal(port.reference(a, b), ref.reference(a, b))
