"""Launch layer: meshes, sharding policies, dry run, roofline, CLI drivers
(PyTorch port of the JAX package's ``launch/``).

NOTE: ``dryrun`` is a process entry point (``python -m
repro_torch.launch.dryrun``: each cell brings up a fake process group of
256 or 512 ranks in its process), so this package ``__init__`` does NOT
import it.
"""

from . import mesh, policy, roofline
from .mesh import HW, make_host_mesh, make_production_mesh

__all__ = [
    "HW",
    "make_host_mesh",
    "make_production_mesh",
    "mesh",
    "policy",
    "roofline",
]
