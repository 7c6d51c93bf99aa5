"""Utilities (port of the parts of mitsuba_tpu/utils/ the port uses)."""
