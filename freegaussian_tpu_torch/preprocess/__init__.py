"""Offline rendering and the cluster mask file (torch)."""
