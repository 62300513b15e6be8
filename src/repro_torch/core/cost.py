"""Time and communication costs for schedules (Sec. 2.4) + lower bounds.

Copy of ``repro.core.cost`` (pure Python), so the port imports nothing of
the JAX package.

Costs are *words moved* and *time steps*, exactly as the paper assigns them:
a schedule's communication cost is the per-step hop count of each variable
set's movement homomorphism mu, times the number of variables, times the
number of steps; time cost is the flattened |T| (rho_T stretching).

Also provides the classical lower bounds the paper cites ([20] Irony-Toledo-
Tiskin, [11] Christ et al.):  per-node bandwidth  Omega(n^3 / (p sqrt(M))),
and the memory-independent  Omega(n^2 / p^{2/3}).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .schedule import TorusSchedule, Torus25DSchedule, torus_hops


@dataclasses.dataclass(frozen=True)
class CommReport:
    words_total: float          # words crossing links, summed over steps
    words_per_node: float
    steps: int
    per_variable: Dict[str, float]


def torus_schedule_cost(sched: TorusSchedule, n: int) -> CommReport:
    """Blocked execution of an n x n x n multiply on the q x q torus under
    ``sched`` (paper Sec. 4.1 blocked variant): each node holds one
    (n/q) x (n/q) block per variable; each time step moves each variable set
    by mu (hop count x q^2 blocks x block words)."""
    q = sched.q
    block_words = (n / q) ** 2
    steps = sched.t
    per_var = {}
    total = 0.0
    for v in ("A", "B", "C"):
        mv = sched.movement(v)
        hops = torus_hops(mv, q) if mv is not None else float("inf")
        words = hops * block_words * q * q * max(steps - 1, 0)
        per_var[v] = words
        total += words
    return CommReport(
        words_total=total,
        words_per_node=total / (q * q),
        steps=steps,
        per_variable=per_var,
    )


def cannon_comm_total(n: int, p: int) -> float:
    """Paper's closed form: blocked Cannon on sqrt(p) x sqrt(p) nodes moves
    ~ 2 * sqrt(p) * p * (n^2/p) = 2 n^2 sqrt(p) words (A and B each one hop
    per step; the paper quotes 3 n^2 sqrt(p) counting all three sets)."""
    return 2.0 * n * n * math.sqrt(p)


def schedule_25d_cost(sched: Torus25DSchedule, n: int) -> CommReport:
    q, c, t = sched.q, sched.c, sched.t
    p = q * q * c
    block_words = (n / q) ** 2
    shift = 2 * block_words * q * q * c * max(t - 1, 0)  # A,B one-hop in-layer
    repl = 2 * block_words * q * q * (c - 1)  # broadcast copies over z
    red = block_words * q * q * (c - 1)  # reduce C over z
    total = shift + repl + red
    return CommReport(
        words_total=total,
        words_per_node=total / p,
        steps=t,
        per_variable={"shift": shift, "replicate": repl, "reduce": red},
    )


def perm_link_words(perm, q: int, block_words: float) -> float:
    """Torus link-words of one executed ppermute: each (src, dst) pair's
    block transits ``torus_hops`` links under minimal routing on the q x q
    torus.  For a translation perm this is hops(mu) * q^2 * block_words --
    the per-step term of ``torus_schedule_cost`` -- but the formula accepts
    arbitrary perms so conformance can price a *wrong* program too."""
    total = 0.0
    for src, dst in perm:
        sx, sy = divmod(int(src), q)
        dx, dy = divmod(int(dst), q)
        total += torus_hops((dx - sx, dy - sy), q) * block_words
    return total


# ---------------------------------------------------------------------------
# Lower bounds
# ---------------------------------------------------------------------------


def bandwidth_lower_bound(n: int, p: int, M: float) -> float:
    """Irony-Toledo-Tiskin [20]: words per node >= n^3/(2*sqrt(2)*p*sqrt(M)) - M."""
    return max(n**3 / (2 * math.sqrt(2) * p * math.sqrt(M)) - M, 0.0)


def memory_independent_lower_bound(n: int, p: int) -> float:
    """[11]: words per node >= c * n^2 / p^(2/3)."""
    return n * n / (p ** (2.0 / 3.0))


def optimal_replication(n: int, p: int, M: float) -> int:
    """The 2.5D sweet spot c = p*M/(3n^2) clamped to [1, p^(1/3)]."""
    c = p * M / (3.0 * n * n)
    return max(1, min(int(c), int(round(p ** (1.0 / 3.0)))))


# ---------------------------------------------------------------------------
# The reference's analytic TPU constants
# ---------------------------------------------------------------------------

# These are the reference's datasheet numbers for a TPU v5e chip, copied
# verbatim because the planner's ranking depends on their ratio: the port's
# plans must equal the reference's.  They describe no NVIDIA card; an H100
# profile comes from calibration (``MachineProfile``), not from here.
PEAK_FLOPS_BF16 = 197e12  # per chip
HBM_BW = 819e9            # bytes/s per chip
ICI_BW = 50e9             # bytes/s per link (one direction)


def calibrated_total_s(flops: float, comm_bytes: float, msgs: float, *,
                       alpha_s: float, bw_bytes_per_s: float,
                       peak_flops: float, overlapped: bool,
                       comm_terms=None, compute_s=None) -> float:
    """Calibrated seconds for one strategy cell: the analytic word/message
    counts priced with *measured* machine parameters (a fitted
    ``repro_torch.obs.profile.MachineProfile``) instead of the datasheet
    constants above.

    ``msgs`` is the strategy's collective-round count (the latency term the
    α–β model adds over the pure-bandwidth analytic model): compute is
    ``flops / peak_flops``, communication ``msgs * α + bytes / bw``, and
    the two combine under the strategy's own overlap rule -- exactly the
    ``Estimate.total_s`` shape, with calibrated coefficients.  With α = 0
    and the datasheet bw/flops this reproduces the analytic ranking
    (``repro_torch.obs.profile.default_profile`` pins that identity).

    ``comm_terms``, when given, replaces the pooled α–β pair with per-axis
    pricing: an iterable of ``(alpha_s, bw_bytes_per_s, bytes, msgs)``
    tuples (one per mesh axis the strategy moves words over), summed into
    the communication time.  The pooled ``alpha_s``/``bw_bytes_per_s``/
    ``comm_bytes``/``msgs`` arguments are ignored in that case.

    ``compute_s``, when given, replaces the peak-FLOPs roofline with a
    *measured* compute time (tuned kernel seconds, the reference's
    ``repro.tune`` path; the port's tuning slice is still to come) on the
    compute side of the same max/sum combination the calibrated comm terms
    sit on.
    """
    if compute_s is None:
        compute_s = flops / max(peak_flops, 1e-9)
    if comm_terms is not None:
        comm_s = sum(ms * a + b / max(bw, 1e-9)
                     for a, bw, b, ms in comm_terms)
    else:
        comm_s = msgs * alpha_s + comm_bytes / max(bw_bytes_per_s, 1e-9)
    return max(compute_s, comm_s) if overlapped else compute_s + comm_s


def matmul_time_model(m: int, n: int, k: int, dtype_bytes: int = 2) -> Dict[str, float]:
    """Single-chip roofline terms of an (m, k) x (k, n) matmul at the
    reference's TPU v5e datasheet rates above (``PEAK_FLOPS_BF16``,
    ``HBM_BW``): the reference's model, copied for parity.  Its seconds
    are a TPU's, never the card's; the card's terms are
    ``repro_torch.roofline.analysis``'s."""
    flops = 2.0 * m * n * k
    bytes_moved = dtype_bytes * (m * k + k * n + m * n)
    return {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": bytes_moved / HBM_BW,
        "arithmetic_intensity": flops / bytes_moved,
    }
