from mitsuba_tpu_torch.bsdfs.dispatch import bsdf_eval, bsdf_pdf, bsdf_sample
from mitsuba_tpu_torch.bsdfs.table import (
    COMPOSITE, DIELECTRIC, DIFF_TRANS, HANRAHAN_KRUEGER, LAMBERTIAN, MIRROR,
    PHONG, ROUGH_CONDUCTOR, ROUGH_GLASS, WARD, WISCOMBE, MaterialBuilder,
    MaterialTable,
)

__all__ = ["bsdf_eval", "bsdf_pdf", "bsdf_sample", "COMPOSITE",
           "DIELECTRIC", "DIFF_TRANS", "HANRAHAN_KRUEGER", "LAMBERTIAN",
           "MIRROR", "PHONG", "ROUGH_CONDUCTOR", "ROUGH_GLASS", "WARD",
           "WISCOMBE", "MaterialBuilder", "MaterialTable"]
