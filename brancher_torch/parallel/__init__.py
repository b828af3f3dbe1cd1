"""Device meshes and collectives over ``torch.distributed``.

Counterpart of ``brancher_tpu/parallel`` (``mesh.py:1-84``).  The JAX
package runs one controller and ``shard_map`` splits the work; here every
rank of a process group calls the same entry point (SPMD, the convention
``mesh.py``'s docstring sets out).  ``collectives.py`` holds the port's
counterparts of JAX's axis-name primitives.
"""

from .collectives import Axis, all_gather, fold_in, local_block, mesh_axis, pmax, pmean, psum
from .mesh import (
    batch_mesh,
    chain_mesh,
    initialize_distributed,
    make_mesh,
    particle_mesh,
    shard_leading_axis,
)
