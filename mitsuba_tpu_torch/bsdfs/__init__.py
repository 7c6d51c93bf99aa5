from mitsuba_tpu_torch.bsdfs.dispatch import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdfs.table import (
    DIELECTRIC, LAMBERTIAN, MIRROR, PHONG, ROUGH_CONDUCTOR, MaterialBuilder,
    MaterialTable,
)

__all__ = ["bsdf_eval", "bsdf_pdf", "bsdf_sample", "DIELECTRIC",
           "LAMBERTIAN", "MIRROR", "PHONG", "ROUGH_CONDUCTOR",
           "MaterialBuilder", "MaterialTable"]
