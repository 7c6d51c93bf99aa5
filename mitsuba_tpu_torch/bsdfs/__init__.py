from mitsuba_tpu_torch.bsdfs.dispatch import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdfs.table import (
    LAMBERTIAN, PHONG, MaterialBuilder, MaterialTable,
)

__all__ = ["bsdf_eval", "bsdf_pdf", "bsdf_sample", "LAMBERTIAN", "PHONG",
           "MaterialBuilder", "MaterialTable"]
