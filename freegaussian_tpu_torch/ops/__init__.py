"""Math, projection, SH, tile binning and rasterization ops (torch)."""
