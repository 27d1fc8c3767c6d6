"""Application framework (maps reference layer 8, src/app_*.hpp)."""
