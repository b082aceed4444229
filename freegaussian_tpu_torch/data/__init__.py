"""Cameras (torch)."""
