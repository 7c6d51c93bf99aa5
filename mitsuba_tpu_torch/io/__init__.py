"""Scene files and images: the XML loader, mesh files, bitmaps (port of
mitsuba_tpu/io/)."""
