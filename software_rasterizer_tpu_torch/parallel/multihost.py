"""Multi-process runtime: the port of the JAX package's
parallel/multihost.py on `torch.distributed`.

Every rank runs the same program (SPMD). `initialize()` starts the
process group and picks this rank's card, after which
`parallel.mesh.make_render_mesh` lays the ("spp", "tile") mesh over the
ranks and the sharded renders of parallel/render.py sum and gather
through it. `gather_image` assembles a frame on every rank: row shards
are gathered, a sharded render's frame (whole on every rank) is not.

A single process no-ops cleanly, so the same entry point works with one
rank or many.

Both backends take CUDA tensors in the collectives used here
(`all_reduce`, `all_gather`): gloo copies them through the host itself.
PyTorch's backend table lists gloo's `all_gather` as CPU-only, but
torch 2.11's gloo gathers CUDA tensors (chip_smoke.py phase 30 runs it).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from software_rasterizer_tpu_torch.ops.intersect import check_device


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout: Optional[datetime.timedelta] = None,
) -> bool:
    """Start the process group from the arguments or the standard
    `torch.distributed` variables, as `torchrun` sets them: MASTER_ADDR /
    MASTER_PORT (the coordinator), WORLD_SIZE, RANK, LOCAL_RANK and
    LOCAL_WORLD_SIZE. Returns True when a multi-process group was started
    (or already runs), False for a single process, which is left alone.

    `coordinator_address` is an init method ("tcp://host:port",
    "file:///path") or a bare "host:port"; None reads MASTER_ADDR /
    MASTER_PORT. `device` ("cuda" unless the caller asks for "cpu") is
    where this rank renders: on "cuda" the rank takes card LOCAL_RANK
    modulo the node's card count, and raises without a card.

    The backend, unless `backend` names one: "nccl" where every rank of
    the node has its own card (LOCAL_WORLD_SIZE, or for a single node the
    world size, at most the node's card count), "gloo" where ranks share
    a card (NCCL refuses two ranks on one device) and on the CPU. Gloo
    sends the sums and gathers through the host; the renders run on the
    card either way. `process_info()` reports the backend taken. On NCCL
    the group is bound to this rank's card (`device_id`): its
    communicator forms in this call.

    `timeout` (None: the backend's default, 10 minutes on NCCL) bounds
    the start-up and every collective of the group, so that a rank lost
    mid-frame never leaves the survivors waiting longer: gloo raises in
    them (at once where the lost rank's connection closes); on NCCL the
    watchdog catches the collective once it outlasts the timeout and, by
    NCCL's default error handling (TORCH_NCCL_ASYNC_ERROR_HANDLING=3),
    ends each survivor's process after its debug dump, since the host
    thread waits in the device's queue and cannot take an exception."""
    if dist.is_initialized():
        return True
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if num_processes in (None, 1):
        return False  # single process: nothing to do
    if process_id is None:
        if not env.get("RANK"):
            raise ValueError(f"{num_processes} processes but no process_id or RANK")
        process_id = int(env["RANK"])
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        raise ValueError("no coordinator_address and no MASTER_ADDR")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    local_rank = int(env.get("LOCAL_RANK", process_id))
    ranks_on_node = int(env.get("LOCAL_WORLD_SIZE", num_processes))

    device = check_device("cuda" if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    if backend is None:
        own_cards = device.type == "cuda" and ranks_on_node <= torch.cuda.device_count()
        backend = "nccl" if own_cards else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = timeout
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def process_info() -> dict:
    """This rank's place in the world. A device of the port's mesh is a
    rank (one process rendering on one card or on the CPU), so a rank has
    one local device and the world `process_count` of them; `backend` is
    the process group's (None for a single process)."""
    up = dist.is_initialized()
    count = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
        "backend": dist.get_backend() if up else None,
    }


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's `t` (the same shape on each) along dim 0
    in the group's rank order, on `t`'s device; `t` itself for a group of
    one."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


# the attribute `mark_whole_frame` sets on a tensor every rank holds whole
_WHOLE = "_srt_whole_frame"


def mark_whole_frame(t: torch.Tensor) -> torch.Tensor:
    """Mark `t`, a frame every rank holds in full (a sharded render's
    result), so that `gather_image` returns it without a collective.
    Returns `t`; a tensor derived from it is not marked."""
    setattr(t, _WHOLE, True)
    return t


def gather_image(img) -> np.ndarray:
    """Assemble a rendered image onto every rank as a numpy array, as the
    JAX package's `gather_image` does for a global array and for
    host-local rows: a frame returned by a sharded render
    (`sharded_path_render`, `sharded_whitted_render(_exact)`,
    `sharded_raster_render`; marked by `mark_whole_frame`) is already
    whole on every rank and comes back as it is; any other `img` is a
    block of rows (rank r holds block r), and every rank's block is
    stacked along the first axis in rank order. A no-op copy for one
    process."""
    if getattr(img, _WHOLE, False):
        return img.detach().cpu().numpy()
    t = torch.as_tensor(img)
    return gather_rows(t).cpu().numpy()
