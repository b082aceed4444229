"""Offline rendering (torch)."""
