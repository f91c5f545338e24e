"""Multi-process initialization (port of
``pstl_tpu/parallel/distributed.py``).

JAX joins its hosts with ``jax.distributed`` and assembles a global batch
from each host's rows.  Here every process drives one card and joins the
default ``torch.distributed`` group; a rank's rows of a batch are its shard
of the global batch, so nothing is assembled (see ``parallel.mesh``).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from pstl_tpu_torch.parallel.mesh import all_gather_cat, axis_of

#: seconds a collective waits for its peers before it raises, so that a
#: rank that failed does not hang the others
TIMEOUT_S = 600.0
#: the environment ``torchrun`` sets (``env://``)
ENV_KEYS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None, device=None,
                   backend: Optional[str] = None,
                   timeout_s: float = TIMEOUT_S) -> int:
    """Join the default process group and return this process's rank.

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``) unless ``init_method`` (e.g. a
    ``file://`` or ``tcp://`` address), ``world_size`` and ``rank`` are
    given.  A no-op returning 0 when none of it is set (one process), and
    the rank when the group exists already.  The backend is NCCL on the
    card and gloo where ``device`` is "cpu"; ``backend`` overrides it (two
    ranks sharing one card need gloo: NCCL refuses two ranks on one GPU).
    On the card it selects ``device``'s index, else ``LOCAL_RANK``, as
    this process's card."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if init_method is None and not any(k in env for k in ENV_KEYS):
        return 0
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    dev = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else int(
            env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return rank


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rows(n_global: int) -> slice:
    """The row range this process loads of ``n_global`` rows: an equal
    share a rank (``n_global // world``, the JAX arithmetic)."""
    r, w = _rank_world()
    per = n_global // w
    return slice(r * per, (r + 1) * per)


def global_batch_from_local(batch: Dict, mesh, axis: str = "data"
                            ) -> Dict[str, torch.Tensor]:
    """This rank's rows as the shard of the global batch, as tensors.

    JAX assembles a globally sharded array from each host's rows; in the
    port a rank's rows already are its shard (a step runs on them inside
    ``data_sharding(mesh, axis)``), so they are returned as they are.  What
    the assembly needs is checked: the shards must be equal, every array
    with the same leading size on every rank of ``axis`` (ValueError
    otherwise)."""
    out = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in batch.items()}
    ax = axis_of(mesh, axis)
    sizes = torch.tensor([[v.shape[0] if v.ndim else -1
                           for v in out.values()]], dtype=torch.long)
    every = all_gather_cat(sizes, ax.group)
    if not bool((every == every[:1]).all()):
        raise ValueError(f"global_batch_from_local: unequal shards over "
                         f"the {axis!r} axis: leading sizes "
                         f"{every.tolist()} for {list(out)}")
    return out
