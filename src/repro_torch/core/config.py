"""Engine configuration (paper §4.2 knobs): the port's copy of
``repro.core.config``. Frozen and hashable."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of Algorithm 1 / §4.2.2–4.2.3.

    Attributes:
      k_max: static upper bound on partitions (tensor shapes); the paper's cloud
        can grow unboundedly, we grow logically up to k_max and count denials.
      k_init: partitions active at t=0 (paper starts with one worker).
      max_cap: MAXCAP — maximum edge-load capacity of one partition.
      tolerance_param: Eq. 6 `toleranceParameter` (%); scale-in trigger
        l = tolerance_param*MAXCAP/100.
      dest_param: Eq. 7 `param` (%); destinationThreshold = MAXCAP −
        param*MAXCAP/100.
      balance_guard: 'text' → §4.2.2 semantics (AVG_d > TH ⇒ least-loaded);
        'alg1' → Algorithm 1 listing semantics (σ > TH ⇒ affinity path,
        else least-loaded). The two disagree in the paper; 'text' is the
        default.
      autoscale: enable §4.2.3 scale-out/in (SDP=True; baselines=False).
      fennel_gamma / fennel_alpha_scale: Fennel policy constants.
      ldg_slack: LDG capacity slack factor (C = slack * n / k).
    """

    k_max: int = 16
    k_init: int = 1
    max_cap: int = 1 << 30
    tolerance_param: float = 25.0
    dest_param: float = 5.0
    balance_guard: str = "text"
    autoscale: bool = True
    fennel_gamma: float = 1.5
    fennel_alpha_scale: float = 1.0
    ldg_slack: float = 1.1

    def __post_init__(self):
        """Reject malformed configs here, with actionable messages, instead
        of letting them fail deep inside an engine (shape errors from a bad
        k_max, silent no-op scaling from a bad percentage, ...)."""
        if self.balance_guard not in ("text", "alg1"):
            raise ValueError(
                f"balance_guard={self.balance_guard!r} is unknown: expected "
                "'text' (§4.2.2 prose semantics, default) or 'alg1' "
                "(Algorithm 1 listing semantics) — the two disagree in the "
                "paper")
        if self.k_max < 1:
            raise ValueError(
                f"k_max={self.k_max} must be >= 1: it is the static upper "
                "bound on partitions and sizes every (k_max,)-shaped array")
        if not (1 <= self.k_init <= self.k_max):
            raise ValueError(
                f"k_init={self.k_init} must satisfy 1 <= k_init <= k_max="
                f"{self.k_max}: k_init partitions are active at t=0 and the "
                "engine can only grow logically up to k_max — raise k_max or "
                "lower k_init")
        if self.max_cap <= 0:
            raise ValueError(
                f"max_cap={self.max_cap} must be > 0: it is MAXCAP, the "
                "per-partition edge-load capacity (Eqs. 5-7); a non-positive "
                "capacity makes every partition permanently overloaded")
        if not 0.0 <= self.tolerance_param <= 100.0:
            raise ValueError(
                f"tolerance_param={self.tolerance_param} must be a "
                "percentage in [0, 100]: Eq. 6 sets the scale-in trigger to "
                "l = tolerance_param*MAXCAP/100")
        if not 0.0 <= self.dest_param <= 100.0:
            raise ValueError(
                f"dest_param={self.dest_param} must be a percentage in "
                "[0, 100]: Eq. 7 sets destinationThreshold = MAXCAP - "
                "dest_param*MAXCAP/100")
        if self.fennel_gamma <= 1.0:
            raise ValueError(
                f"fennel_gamma={self.fennel_gamma} must be > 1: Fennel's "
                "cost term alpha*|S|^gamma needs a superlinear exponent "
                "(the paper uses 1.5) or the balance pressure vanishes")
        if self.ldg_slack < 1.0:
            raise ValueError(
                f"ldg_slack={self.ldg_slack} must be >= 1: LDG capacity is "
                "C = slack*n/k, and slack < 1 under-provisions every "
                "partition below an even split")


POLICIES = ("sdp", "ldg", "fennel", "hash", "random", "greedy")
