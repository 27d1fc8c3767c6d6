"""Quadtree AMR mesh: host tree and the dense block layout."""
