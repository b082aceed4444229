"""HTTP viewer (torch)."""

from .server import ViewerServer, orbit_camera, render_orbit_view

__all__ = ["ViewerServer", "orbit_camera", "render_orbit_view"]
