"""Device-mesh construction for rendering workloads: the port of the JAX
package's parallel/mesh.py over the ranks of a `torch.distributed`
group.

Axes:

  * ``spp``  — sample-parallelism: each slice of ranks computes a
    disjoint range of per-pixel sample indices; partial sum-images merge
    with one all-reduce (the renderer's data-parallel axis).
  * ``tile`` — screen-space parallelism: the framebuffer's pixel lanes
    are split; a pure map with no communication until the final gather
    (the renderer's spatial/context-parallel axis).

Ranks are laid out spp-major, as the JAX mesh lays out its devices:
rank r has the coordinates (r // n_tile, r % n_tile), so the flat index
spp_index * n_tile + tile_index is the rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from software_rasterizer_tpu_torch.ops.intersect import check_device


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A named 2-axis mesh ("spp", "tile") of ranks, this rank's place on
    it and the device it renders on. `mesh` is the `DeviceMesh`, or None
    for the one-rank mesh, which needs no process group."""

    n_spp: int
    n_tile: int
    spp_index: int
    tile_index: int
    device: torch.device
    mesh: Optional[object] = None

    @property
    def n_devices(self) -> int:
        return self.n_spp * self.n_tile

    @property
    def index(self) -> int:
        """This rank's flat index on the mesh (spp-major)."""
        return self.spp_index * self.n_tile + self.tile_index

    def group(self, axis: Optional[str] = None):
        """The process group of `axis` ("spp" or "tile"), or of the whole
        mesh for None; None on the one-rank mesh."""
        if self.mesh is None:
            return None
        return dist.group.WORLD if axis is None else self.mesh.get_group(axis)


def make_render_mesh(
    n_spp: int = 1,
    n_tile: Optional[int] = None,
    device=None,
) -> RenderMesh:
    """Build a ("spp", "tile") mesh over the ranks of the process group
    (one rank when none was started). `n_tile` defaults to
    world_size // n_spp. A mesh of more than one device spans every rank;
    a (1, 1) mesh runs in this process alone. `device` ("cuda" unless the
    caller asks for "cpu") is where this rank renders: on "cuda" the card
    `multihost.initialize` selected."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_tile is None:
        if world % n_spp:
            raise ValueError(f"{world} devices not divisible by spp={n_spp}")
        n_tile = world // n_spp
    n = n_spp * n_tile
    if n > world:
        raise ValueError(f"mesh {n_spp}x{n_tile} needs {n} devices, have {world}")
    if n_spp < 1 or n_tile < 1:
        raise ValueError(f"mesh {n_spp}x{n_tile} has no device")
    if 1 < n < world:
        raise ValueError(f"mesh {n_spp}x{n_tile} covers {n} of {world} ranks: a "
                         f"mesh of more than one device spans every rank")
    device = check_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if n == 1:
        return RenderMesh(1, 1, 0, 0, device)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device.type, (n_spp, n_tile),
                            mesh_dim_names=("spp", "tile"))
    spp_index, tile_index = mesh.get_coordinate()
    return RenderMesh(n_spp, n_tile, spp_index, tile_index, device, mesh)
