"""Distribution layer of the port (the counterpart of mara3_tpu/parallel/).

``iso2d_sharded`` x-shards kh's uniform periodic grid over a list of
devices under one controller; the other modules of the JAX package's
``parallel/`` are not ported yet (ROADMAP.md queue A item 11).
"""
