"""Hydrodynamic systems (maps reference src/physics_*.hpp)."""
