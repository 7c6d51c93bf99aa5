from mitsuba_tpu_torch.emitters.table import (
    AREA, SKY, EmitterBuilder, EmitterTable, eval_and_pdf_environment,
    eval_emitter_hit, eval_environment, pdf_direct_area, pdf_environment,
    sample_direct,
)

__all__ = ["AREA", "SKY", "EmitterBuilder", "EmitterTable",
           "eval_and_pdf_environment", "eval_emitter_hit",
           "eval_environment", "pdf_direct_area", "pdf_environment",
           "sample_direct"]
