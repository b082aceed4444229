"""Gaussian parameters, deform field, stage-1 model and checkpoint IO (torch)."""
