"""Metrics, colormaps, checkpoint IO and device selection."""
