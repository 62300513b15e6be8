"""Homomorphisms between the paper's groups, given by generator images.

A homomorphism rho: G -> H from a group generated by ``gens`` is fixed by the
images of the generators (paper App. A, Def. 4).  For the cyclic/abelian case
that drives all torus schedules, well-definedness reduces to an order check:
the order of rho(g) must divide the order of g.  We verify that, plus (for
sampled elements) the defining property rho(ab) = rho(a)rho(b).

This module also carries the paper's Lemmas 3-5 as executable checks: for
prime q, non-trivial homomorphisms  G <= S_q -> Z/qZ  exist only from cyclic
subgroups generated by a primitive permutation, and then q | t.

Copy of ``repro.core.homomorphism`` (standard library only), so the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence, Tuple

from .groups import CyclicGroup, Permutation, ProductGroup


@dataclasses.dataclass(frozen=True)
class AbelianHom:
    """rho: Z^{k}-presented abelian group -> ProductGroup, by generator images.

    ``source_orders[i]`` is the order of the i-th generator (q for Sigma_q,
    t for Z/tZ, 2 for S2 factors).  ``images[i]`` is its image tuple in the
    target.  Well-definedness: order(images[i]) divides source_orders[i].
    """

    source_orders: Tuple[int, ...]
    target: ProductGroup
    images: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        assert len(self.source_orders) == len(self.images)

    def is_well_defined(self) -> bool:
        for order, img in zip(self.source_orders, self.images):
            if order % self.target.order_of(img) != 0:
                return False
        return True

    def apply(self, exponents: Sequence[int]) -> Tuple[int, ...]:
        """Image of prod_i gen_i^{e_i} (source abelian => order irrelevant)."""
        out = self.target.identity
        for e, img in zip(exponents, self.images):
            out = self.target.add(out, self.target.mul(img, e))
        return out

    def image_size(self) -> int:
        """|im(rho)| -- needed for the embedding condition (Prop. 3)."""
        seen = {self.target.identity}
        frontier = [self.target.identity]
        gens = [img for img in self.images]
        while frontier:
            x = frontier.pop()
            for g in gens:
                y = self.target.add(x, g)
                if y not in seen:
                    seen.add(y)
                    frontier.append(y)
        return len(seen)


def verify_hom_property(
    rho: Callable, add_src: Callable, add_dst: Callable, samples: Sequence
) -> bool:
    """Spot-check rho(a+b) == rho(a)+rho(b) on sample pairs."""
    for a in samples:
        for b in samples:
            if rho(add_src(a, b)) != add_dst(rho(a), rho(b)):
                return False
    return True


# ---------------------------------------------------------------------------
# Lemmas 3-5 (executable form, used by property tests)
# ---------------------------------------------------------------------------


def hom_exists_perm_to_cyclic(sigma: Permutation, q: int, image: int) -> bool:
    """Can the cyclic subgroup <sigma> <= S_q map to Z/qZ with sigma -> image?

    Well-defined iff order(image in Z/qZ) divides order(sigma).  Lemma 3 says
    that for prime q an imprimitive sigma forces image = 0; Lemma 4 that a
    non-trivial homomorphism's domain is generated by a primitive permutation.
    """
    grp = CyclicGroup(q)
    return sigma.order() % grp.order_of(image) == 0


def lemma3_imprimitive_in_kernel(sigma: Permutation, q: int) -> bool:
    """For prime q: imprimitive sigma admits only the trivial image in Z/qZ."""
    if sigma.is_primitive():
        return True  # lemma vacuous
    return all(not hom_exists_perm_to_cyclic(sigma, q, x) for x in range(1, q))


def lemma5_q_divides_t(q: int, t: int) -> bool:
    """A non-trivial hom G <= S_q -> Z/tZ (q prime) requires q | t: the domain
    is cyclic of order divisible by q (Lemma 4), so its image's order divides
    both q^a and t; non-triviality forces q | t."""
    return t % q == 0


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(math.isqrt(n)) + 1):
        if n % p == 0:
            return False
    return True
