"""Hydrodynamic systems (maps reference src/physics_*.hpp).

Each system is a module of plain torch functions over tensors whose
trailing axis is the component axis. Interface normals (`nhat`) are
length-3 tuples of floats, axis unit vectors in practice.
"""

UNIT_VECTOR_X = (1.0, 0.0, 0.0)
UNIT_VECTOR_Y = (0.0, 1.0, 0.0)
UNIT_VECTOR_Z = (0.0, 0.0, 1.0)


def on_axis(axis: int):
    """Axis unit vector (reference unit_vector_t::on_axis_{1,2,3},
    core_geometric.hpp)."""
    return (UNIT_VECTOR_X, UNIT_VECTOR_Y, UNIT_VECTOR_Z)[axis]
