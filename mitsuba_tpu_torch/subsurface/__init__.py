from mitsuba_tpu_torch.subsurface.dipole import (
    DipoleParams, make_dipole, sample_irradiance_points, compute_irradiance,
    dipole_rd, dipole_lo, prepare_dipole, multipole_rd, adipole_rd,
)

__all__ = [
    "DipoleParams", "make_dipole", "sample_irradiance_points",
    "compute_irradiance", "dipole_rd", "dipole_lo", "prepare_dipole",
    "multipole_rd", "adipole_rd",
]
