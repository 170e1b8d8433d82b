"""The paper's own arch: the distributed EBBkC clique engine.

Cells lower ``count_packed`` (plex routing + kernels) over sharded tile
batches -- the EdgeParallel scheme of paper Section 6.2(7) on the
production mesh.  These cells are *extra* (beyond the assigned 40)."""
import dataclasses

from .base import ArchSpec, ShapeCell


@dataclasses.dataclass(frozen=True)
class CliqueEngineConfig:
    tile_T: int = 64
    l: int = 3
    method: str = "mxu"


FULL = CliqueEngineConfig()
REDUCED = CliqueEngineConfig(tile_T=32, l=3, method="mxu")

CELLS = {
    "ep_tri_1m": ShapeCell("ep_tri_1m", "clique",
                           dims=dict(n_tiles=1048576, T=64, l=3)),
    "ep_tri_128": ShapeCell("ep_tri_128", "clique",
                            dims=dict(n_tiles=262144, T=128, l=3)),
    "ep_l4_ref": ShapeCell("ep_l4_ref", "clique",
                           dims=dict(n_tiles=65536, T=64, l=4)),
}

SPEC = ArchSpec(
    name="ebbkc", family="clique", full=FULL, reduced=REDUCED, cells=CELLS,
    notes="tiles sharded over every mesh axis (EP); per-device partial "
          "counts psum-reduced",
)
