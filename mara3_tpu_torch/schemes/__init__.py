"""Finite-volume schemes built from the physics and mesh layers."""
