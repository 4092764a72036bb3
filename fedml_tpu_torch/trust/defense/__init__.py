"""Defense registry (the port of ``fedml_tpu/trust/defense/__init__.py``).

Parity with ``FedMLDefender`` dispatch (``core/security/fedml_defender.py:63-91``):
the config key ``defense_type`` selects the defense; the trust pipeline
applies its three hooks around aggregation, over the stacked ``(m, d)``
client-update matrix on its device (``base.py``).
"""

from __future__ import annotations

from .anomaly import (CrossRoundDefense, FoolsGoldDefense, OutlierDetectionDefense,
                      ResidualReweightDefense, ThreeSigmaDefense, ThreeSigmaGeoMedianDefense,
                      ThreeSigmaKrumDefense)
from .base import Defense, weighted_mean
from .clipping import (CClipDefense, CRFLDefense, NormDiffClippingDefense,
                       RobustLearningRateDefense, SLSGDDefense, WeakDPDefense)
from .robust_agg import (BulyanDefense, CoordinateWiseMedianDefense, GeometricMedianDefense,
                         KrumDefense, MultiKrumDefense, TrimmedMeanDefense)
from .soteria import SoteriaDefense, WBCDefense, soteria_mask, soteria_sensitivity

_REGISTRY = {
    "krum": KrumDefense,
    "multikrum": MultiKrumDefense,
    "geometric_median": GeometricMedianDefense,
    "RFA": GeometricMedianDefense,  # reference alias
    "coordinate_median": CoordinateWiseMedianDefense,
    "coordinate_wise_median": CoordinateWiseMedianDefense,
    "trimmed_mean": TrimmedMeanDefense,
    "coordinate_wise_trimmed_mean": TrimmedMeanDefense,
    "bulyan": BulyanDefense,
    "norm_diff_clipping": NormDiffClippingDefense,
    "cclip": CClipDefense,
    "weak_dp": WeakDPDefense,
    "slsgd": SLSGDDefense,
    "robust_learning_rate": RobustLearningRateDefense,
    "crfl": CRFLDefense,
    "foolsgold": FoolsGoldDefense,
    "three_sigma": ThreeSigmaDefense,
    "three_sigma_geomedian": ThreeSigmaGeoMedianDefense,
    "three_sigma_krum": ThreeSigmaKrumDefense,
    "outlier_detection": OutlierDetectionDefense,
    "residual_reweight": ResidualReweightDefense,
    "cross_round": CrossRoundDefense,
    "soteria": SoteriaDefense,
    "wbc": WBCDefense,
}


def names() -> list[str]:
    return sorted(_REGISTRY)


def create(cfg) -> Defense:
    dt = getattr(cfg, "defense_type", "")
    try:
        return _REGISTRY[dt](cfg)
    except KeyError:
        raise ValueError(f"unknown defense_type {dt!r}; known: {names()}") from None


__all__ = ["Defense", "create", "names", "soteria_mask", "soteria_sensitivity", "weighted_mean"]
