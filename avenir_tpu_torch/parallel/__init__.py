"""The device mesh and its collectives (``parallel/mesh.py``): the port's
counterpart of ``avenir_tpu/parallel``."""

from .mesh import (  # noqa: F401
    Mesh,
    all_gather,
    get_mesh,
    make_mesh,
    pad_rows,
    ppermute_ring,
    psum,
    replicate,
    shard_rows,
)
