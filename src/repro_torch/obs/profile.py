"""Versioned machine profiles: measured α–β link parameters for the planner.

Port of the part of ``repro.obs.profile`` that ``repro_torch.plan.ir``
reads: ``LinkParams``, ``MachineProfile`` (with its JSON form) and
``default_profile``.  The calibration run that fits a profile on a card
(the reference's ``repro.obs.calibrate.probe_links`` and
``repro.launch.perf_probe``) is a later slice of the port.

A :class:`MachineProfile` is what a calibration run persists: per link class, the fitted per-message latency α (seconds) and
bandwidth β⁻¹ (bytes/s), plus the measured peak matmul FLOPs.  The planner
(``build_plan(profile=...)`` → ``rank_mesh_strategies``) then ranks
strategies by **calibrated seconds** -- ``core.cost.calibrated_total_s``
applied to the analytic ``Estimate``'s word counts and message counts --
while the word counts themselves stay analytic, so the conformance harness
keeps checking exact words.

Profiles are frozen/hashable (they participate in the plan-cache key) and
serialize to schema-versioned JSON (``save``/``load``).
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

    ``tuning`` is the reference's embedded ``repro.tune.TuningTable``; the
    port has no tuning slice yet, so it must stay ``None`` (``build_plan``
    raises on a profile that carries one)."""

    platform: str
    peak_flops: float
    links: Tuple[Tuple[str, LinkParams], ...]
    created: str = ""
    schema: int = PROFILE_SCHEMA
    tuning: Optional[object] = None  # must be None until the tuning slice

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
        if obj.get("tuning"):
            raise NotImplementedError(
                "machine profile embeds a tuning table; the port's tuning "
                "slice is not there yet")
        return cls(
            platform=obj.get("platform", "unknown"),
            peak_flops=float(obj["peak_flops"]),
            links=tuple(sorted(
                (n, LinkParams(float(p["alpha_s"]),
                               float(p["bw_bytes_per_s"])))
                for n, p in obj.get("links", {}).items())),
            created=obj.get("created", ""),
            schema=schema or PROFILE_SCHEMA,
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
