"""Denoise pipelines."""
