"""AMR meshes: the host quadtree and octree, their dense block layouts,
prolongation and restriction, and regridding."""
