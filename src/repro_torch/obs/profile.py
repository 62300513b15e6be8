"""Versioned machine profiles: measured α–β link parameters for the planner.

Port of ``repro.obs.profile``.  A :class:`MachineProfile` is what a
calibration run (``repro_torch.obs.calibrate.probe_links`` / ``python -m
repro_torch.launch.perf_probe``) persists: per link class, the fitted
per-message latency α (seconds) and
bandwidth β⁻¹ (bytes/s), plus the measured peak matmul FLOPs.  The planner
(``build_plan(profile=...)`` → ``rank_mesh_strategies``) then ranks
strategies by **calibrated seconds** -- ``core.cost.calibrated_total_s``
applied to the analytic ``Estimate``'s word counts and message counts --
while the word counts themselves stay analytic, so the conformance harness
keeps checking exact words.

Profiles are frozen/hashable (they participate in the plan-cache key) and
serialize to the reference's schema-versioned JSON (``save``/``load``), so
a profile written by one package loads in the other.  The port adds two
optional keys the reference ignores: ``device_kind`` (the card's name) and
``link_medium`` (what the links were: on one card the ranks are threads
and every "link" is a device copy between them).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

PROFILE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """Fitted α–β model of one link class: transfer time for ``b`` bytes is
    ``alpha_s + b / bw_bytes_per_s``."""

    alpha_s: float
    bw_bytes_per_s: float

    def seconds(self, num_bytes: float, msgs: float = 1) -> float:
        return msgs * self.alpha_s + num_bytes / self.bw_bytes_per_s


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """Calibrated machine parameters the planner ranks with.

    ``tuning`` optionally embeds a ``repro_torch.tune.TuningTable`` (the
    ``perf_probe --tune`` artifact): ``build_plan(profile=...)`` then
    prices the compute side with measured kernel seconds wherever the
    table covers the local bucket, alongside the fitted α–β comm terms."""

    platform: str
    peak_flops: float
    links: Tuple[Tuple[str, LinkParams], ...]
    created: str = ""
    schema: int = PROFILE_SCHEMA
    tuning: Optional[object] = None  # repro_torch.tune.TuningTable (lazy import)
    device_kind: str = ""
    link_medium: str = ""

    def link(self, name: str = "ici") -> LinkParams:
        """Params for ``name``, falling back to the first link class (a
        profile with any measurement beats no profile)."""
        for n, p in self.links:
            if n == name:
                return p
        if self.links:
            return self.links[0][1]
        raise ValueError(f"profile has no link classes (wanted {name!r})")

    def seconds(self, est, link: str = "ici", *,
                compute_s: Optional[float] = None) -> float:
        """Calibrated total seconds for an analytic ``dist.api.Estimate``:
        compute from the measured peak FLOPs, communication from the fitted
        α–β applied to the estimate's bytes and message count, combined
        with the estimate's own overlap rule.  ``compute_s`` substitutes a
        measured compute time (tuned kernel seconds -- the planner derives
        it from ``tuning`` per local shape) for the roofline term.

        When the estimate carries per-axis terms (``est.comm_by_axis``) AND
        this profile has a fitted ``axis:{name}`` link class for *every*
        axis in them, each axis's bytes/messages are priced with its own
        α–β and summed -- heterogeneous multi-axis meshes rank correctly.
        Otherwise the pooled ``link`` class prices the totals, preserving
        the ``default_profile`` analytic-ranking identity."""
        from repro_torch.core.cost import calibrated_total_s

        lp = self.link(link)
        names = {n for n, _ in self.links}
        terms = None
        by_axis = getattr(est, "comm_by_axis", ())
        if by_axis and all(f"axis:{ax}" in names for ax, _, _ in by_axis):
            terms = tuple(
                (self.link(f"axis:{ax}").alpha_s,
                 self.link(f"axis:{ax}").bw_bytes_per_s, b, ms)
                for ax, b, ms in by_axis)
        return calibrated_total_s(
            2.0 * est.m * est.n * est.k / max(est.tp, 1),
            est.comm_bytes, est.msgs,
            alpha_s=lp.alpha_s, bw_bytes_per_s=lp.bw_bytes_per_s,
            peak_flops=self.peak_flops, overlapped=est.overlapped,
            comm_terms=terms, compute_s=compute_s)

    def to_json(self) -> Dict:
        obj = {
            "schema": self.schema,
            "platform": self.platform,
            "peak_flops": self.peak_flops,
            "created": self.created,
            "links": {n: {"alpha_s": p.alpha_s,
                          "bw_bytes_per_s": p.bw_bytes_per_s}
                      for n, p in self.links},
        }
        if self.device_kind:
            obj["device_kind"] = self.device_kind
        if self.link_medium:
            obj["link_medium"] = self.link_medium
        if self.tuning is not None:
            obj["tuning"] = self.tuning.to_json()
        return obj

    @classmethod
    def from_json(cls, obj: Dict) -> "MachineProfile":
        schema = int(obj.get("schema", 0))
        if schema > PROFILE_SCHEMA:
            raise ValueError(
                f"machine profile schema {schema} is newer than supported "
                f"{PROFILE_SCHEMA}; re-run calibration")
        tuning = None
        if obj.get("tuning"):
            from repro_torch.tune.table import TuningTable

            tuning = TuningTable.from_json(obj["tuning"])
        return cls(
            platform=obj.get("platform", "unknown"),
            peak_flops=float(obj["peak_flops"]),
            links=tuple(sorted(
                (n, LinkParams(float(p["alpha_s"]),
                               float(p["bw_bytes_per_s"])))
                for n, p in obj.get("links", {}).items())),
            created=obj.get("created", ""),
            schema=schema or PROFILE_SCHEMA,
            tuning=tuning,
            device_kind=obj.get("device_kind", ""),
            link_medium=obj.get("link_medium", ""),
        )


def save_profile(profile: MachineProfile, path: str) -> str:
    with open(path, "w") as f:
        json.dump(profile.to_json(), f, indent=1, sort_keys=True)
    return path


def load_profile(path: str) -> MachineProfile:
    with open(path) as f:
        return MachineProfile.from_json(json.load(f))


def default_profile() -> MachineProfile:
    """The reference's analytic TPU constants as a profile (α = 0): ranking
    with it reproduces the uncalibrated cost model exactly -- the identity
    the tests pin.  Not a profile of any NVIDIA card."""
    from repro_torch.core import cost as _cost

    return MachineProfile(
        platform="analytic",
        peak_flops=_cost.PEAK_FLOPS_BF16,
        links=(("ici", LinkParams(0.0, _cost.ICI_BW)),),
    )


def fit_alpha_beta(sizes_bytes, times_s) -> LinkParams:
    """Least-squares fit of ``t = α + bytes / bw`` over measured
    (bytes, seconds) points.  α is clamped to ≥ 0 and bw to > 0 so noisy
    microbenchmarks can never produce a nonsensical profile."""
    xs = [float(x) for x in sizes_bytes]
    ys = [float(y) for y in times_s]
    if len(xs) != len(ys) or not xs:
        raise ValueError("need equal, nonempty sizes/times")
    n = len(xs)
    if n == 1 or max(xs) == min(xs):
        # one point: attribute everything to bandwidth
        return LinkParams(0.0, max(xs[0] / max(ys[0], 1e-12), 1.0))
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxy = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    slope = sxy / sxx if sxx else 0.0  # seconds per byte
    alpha = my - slope * mx
    if slope <= 0:
        # latency-flat regime: charge the mean time as pure latency
        return LinkParams(max(my, 0.0), 1e15)
    return LinkParams(max(alpha, 0.0), 1.0 / slope)
