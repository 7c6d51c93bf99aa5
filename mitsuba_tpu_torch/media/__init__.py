from mitsuba_tpu_torch.media.phase import (
    HG, ISOTROPIC, KAJIYA_KAY, MICROFLAKE, MICROFLAKE_GAUSS,
    phase_eval, phase_pdf, phase_sample,
)
from mitsuba_tpu_torch.media.medium import (
    HETEROGENEOUS, HOMOGENEOUS, MediumTable, make_heterogeneous,
    make_homogeneous, medium_transmittance, no_medium, sample_distance,
)

__all__ = [
    "ISOTROPIC", "HG", "KAJIYA_KAY", "MICROFLAKE", "MICROFLAKE_GAUSS",
    "phase_eval", "phase_pdf", "phase_sample",
    "HOMOGENEOUS", "HETEROGENEOUS", "MediumTable", "make_homogeneous",
    "make_heterogeneous", "no_medium", "medium_transmittance",
    "sample_distance",
]
