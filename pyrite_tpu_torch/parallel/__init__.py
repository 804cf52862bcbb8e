"""Multi-device rendering: sample-axis sharding over torch.distributed."""

from .mesh import (  # noqa: F401
    Mesh,
    device_film_buffers,
    local_mesh,
    make_mesh,
    merge_films,
    run_sharded,
    spawn,
)
