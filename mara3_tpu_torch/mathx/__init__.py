"""Numerical building blocks (maps reference src/math_*.hpp)."""
