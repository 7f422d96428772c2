"""mesh_to_sdf_tpu — a differentiable mesh→SDF framework in JAX.

Brand-new JAX/Pallas re-design with the capabilities of the reference Rust
crate `Azkellas/mesh_to_sdf` (see SURVEY.md): signed distance fields at
arbitrary query points (`generate_sdf`) or on regular grids
(`generate_grid_sdf`), raycast/normal sign methods, versioned serialization,
glTF ingestion, offline raymarch rendering — plus new capabilities:
vertex gradients via custom VJP and multi-chip sharding over device meshes.
"""
from .grid import Grid
from .topology import Topology, as_points
from .types import AccelerationMethod, SignMethod, Strategy, F32_MAX
from .query import generate_sdf
from .gridgen import generate_grid_sdf
from .ops.keyed import compare_distances

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "Topology",
    "as_points",
    "AccelerationMethod",
    "SignMethod",
    "Strategy",
    "F32_MAX",
    "generate_sdf",
    "generate_grid_sdf",
    "compare_distances",
    "__version__",
]
