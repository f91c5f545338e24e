"""Device mesh, batch sharding and the sharding contexts (port of
``pstl_tpu/parallel/mesh.py``).

JAX shards arrays over a device mesh and lets GSPMD insert the collectives.
Here a mesh is a ``torch.distributed`` ``DeviceMesh`` over processes, one
a card, and every rank runs the same program on its own rows with explicit
collectives where rows meet.  The contract is GSPMD's: a mesh changes where
rows run, not what they compute.

- **Data parallelism** (the scene axis, "data").  ``shard_batch`` gives a
  rank its rows.  Code run inside ``with data_sharding(mesh):`` treats its
  batch as this rank's shard of the whole: every draw is made whole from
  the seeded generator and sliced (:func:`draw`), so each row gets the
  numbers it gets unsharded; a mean that divides by a data-dependent count
  (``ops.guidance_loss.mask_mean``) takes the count over all ranks; a loss
  whose gradient moves the rows themselves (guidance, refinement) is
  scaled by ``1 / shard_world()`` so that each row's gradient is the whole
  batch's.  The train loop all-reduces the gradients
  (:func:`all_reduce_grads`) and the metrics (:func:`psum_metrics`).
- **Candidate parallelism** (one scene's candidate fan, "cand").  Inside
  ``with candidate_sharding(mesh, "cand"):`` the planner
  (``sim.make_planner``) runs the sampler on a share of every scene's
  candidates, split by seed index: with r = j*M + m (maneuver j, seed m),
  rank k holds m in [k*M', (k+1)*M'), M' = M / world, so its
  (bs, nt, 2, 3*M') layout is one the guidance kernels run unchanged (a
  contiguous split of R would cut a maneuver group).  It draws the whole
  noise and keeps its columns (:func:`constrain_candidates`), gathers the
  decodings (:func:`gather_candidates`) and runs the selection replicated.

Collectives on a gloo group go through the host (two ranks sharing one
card must use gloo); world-1 axes make no collective at all.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""
    group: object
    rank: int
    world: int


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              device_type: Optional[str] = None):
    """A mesh over the processes of the default group (one a card), shaped
    ``shape`` (one axis over every rank by default; a -1 absorbs the
    remaining ranks) with ``axis_names`` (``Config.mesh_shape`` /
    ``mesh_axis_names``).  Without a process group (one process, no
    ``torchrun``) a world-1 group is made first, in-process: NCCL for
    ``device_type`` "cuda" (the default where there is a card), gloo for
    "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    shape = [n] if shape is None else [int(s) for s in shape]
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1) or 1
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} with axes "
                         f"{tuple(axis_names)} does not cover {n} ranks")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def axis_of(mesh, axis: str) -> Axis:
    """``mesh``'s axis ``axis``: its process group, this rank's index on it
    and its size."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    return Axis(mesh.get_group(axis), mesh.get_local_rank(axis),
                mesh.size(names.index(axis)))


# ---------------------------------------------------------------------------
# collectives (the host for gloo)
# ---------------------------------------------------------------------------

def _comm_copy(x: Tensor, group) -> Tensor:
    dev = x.device
    if dist.get_backend(group) != "nccl":
        dev = torch.device("cpu")
    return x.detach().to(dev, copy=True).contiguous()


def all_reduce(x: Tensor, group, op=dist.ReduceOp.SUM) -> Tensor:
    """A reduced copy of ``x`` over ``group``, on ``x``'s device."""
    y = _comm_copy(x, group)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def all_gather_cat(x: Tensor, group, dim: int = 0) -> Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in rank
    order, on ``x``'s device."""
    y = _comm_copy(x, group)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim).to(x.device)


# ---------------------------------------------------------------------------
# placements and batch sharding
# ---------------------------------------------------------------------------

_DATA: List[Optional[Axis]] = [None]       # the entered data sharding's
_CAND_MESH: List[Optional[Axis]] = [None]  # candidate_sharding's axis
_CAND: List = [None]                       # (Axis, M') in the planner


class Sharding:
    """A placement on a mesh: rows split over ``axis`` on their leading
    axis, or replicated (``axis`` None).  Entered as a context it says that
    the tensors inside are this rank's rows of the whole (module
    docstring); a replicated placement clears that."""

    def __init__(self, mesh, axis: Optional[str]):
        self.mesh, self.axis = mesh, axis

    def __enter__(self):
        self._prev = _DATA[0]
        _DATA[0] = None if self.axis is None else axis_of(self.mesh,
                                                           self.axis)
        return self

    def __exit__(self, *exc):
        _DATA[0] = self._prev
        return False


def data_sharding(mesh, axis: str = "data") -> Sharding:
    """The leading (scene) axis split over ``axis``, the rest replicated."""
    return Sharding(mesh, axis)


def replicate(mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch: Dict, mesh, axis: str = "data") -> Dict:
    """This rank's rows of every array (numpy or torch) whose leading axis
    divides by the size of ``axis``; any other array, and None, is kept
    whole, as JAX replicates it."""
    ax = axis_of(mesh, axis)

    def place(x):
        if x is not None and getattr(x, "ndim", 0) >= 1 \
                and x.shape[0] % ax.world == 0:
            per = x.shape[0] // ax.world
            return x[ax.rank * per:(ax.rank + 1) * per]
        return x

    return {k: place(v) for k, v in batch.items()}


def gather_rows(x: Tensor, mesh, axis: str = "data", dim: int = 0) -> Tensor:
    """The whole of rows sharded over ``axis`` (``shard_batch``'s
    inverse)."""
    ax = axis_of(mesh, axis)
    return x if ax.world == 1 else all_gather_cat(x, ax.group, dim)


def psum_metrics(metrics: Dict[str, Tensor], mesh,
                 axis: str = "data") -> Dict[str, Tensor]:
    """Every scalar metric's mean over the ranks of ``axis`` (one
    all-reduce); equal shards make it the whole batch's."""
    ax = axis_of(mesh, axis)
    if ax.world == 1 or not metrics:
        return dict(metrics)
    keys = list(metrics)
    v = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    v = all_reduce(v, ax.group) / ax.world
    return dict(zip(keys, v.unbind()))


def _buckets(tensors):
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    return by_dtype.values()


def all_reduce_grads(params, mesh, axis: str = "data") -> None:
    """Average the gradients that exist over the ranks of ``axis``: one
    flattened bucket a dtype, one all-reduce each (what JAX's psum of the
    gradients does)."""
    ax = axis_of(mesh, axis)
    grads = [p.grad for p in params if p.grad is not None]
    if ax.world == 1 or not grads:
        return
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        flat = all_reduce(flat, ax.group) / ax.world
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def broadcast_module(module: torch.nn.Module, mesh,
                     axis: str = "data") -> None:
    """Every parameter and buffer of ``module`` from rank 0 of ``axis``."""
    ax = axis_of(mesh, axis)
    if ax.world == 1:
        return
    src = dist.get_global_rank(ax.group, 0)
    tensors = [t for t in list(module.parameters()) + list(module.buffers())]
    with torch.no_grad():
        for bucket in _buckets(tensors):
            flat = _comm_copy(torch.cat([t.reshape(-1) for t in bucket]),
                              ax.group)
            dist.broadcast(flat, src=src, group=ax.group)
            flat = flat.to(bucket[0].device)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


# ---------------------------------------------------------------------------
# the sharded program: whole draws sliced, counts over all ranks
# ---------------------------------------------------------------------------

class candidate_sharding:
    """Context enabling candidate-axis sharding of the planner's sampler
    over ``axis`` of ``mesh``; ``sim.make_planner``'s plan reads it when it
    is called (module docstring)."""

    def __init__(self, mesh, axis: str = "cand"):
        self._axis = axis_of(mesh, axis)

    def __enter__(self):
        self._prev = _CAND_MESH[0]
        _CAND_MESH[0] = self._axis
        return self

    def __exit__(self, *exc):
        _CAND_MESH[0] = self._prev
        return False


def candidate_axis() -> Optional[Axis]:
    """The axis of the entered ``candidate_sharding``, or None."""
    return _CAND_MESH[0]


@contextlib.contextmanager
def candidate_share(ax: Axis, m_local: int):
    """The planner's sampler section: this rank holds seeds
    [rank * m_local, (rank + 1) * m_local) of every scene and maneuver."""
    prev = _CAND[0]
    _CAND[0] = (ax, m_local)
    try:
        yield
    finally:
        _CAND[0] = prev


def _active() -> List[Axis]:
    out = [a for a in (_DATA[0],) if a is not None]
    if _CAND[0] is not None:
        out.append(_CAND[0][0])
    return out


def _take(x: Tensor, dim: int, g_local: int, rank: int, world: int
          ) -> Tensor:
    """Along ``dim``, in every group of ``g_local * world`` entries, this
    rank's ``g_local``."""
    dim %= x.ndim
    n, g = x.shape[dim], g_local * world
    if n % g:
        raise ValueError(f"axis {dim} of size {n} does not split into "
                         f"groups of {g_local} x {world} ranks")
    v = x.reshape(*x.shape[:dim], n // g, g, *x.shape[dim + 1:])
    v = v.narrow(dim + 1, rank * g_local, g_local)
    return v.reshape(*x.shape[:dim], n // world, *x.shape[dim + 1:])


def _cand_axis(rows: int, cands: Optional[int]):
    """(axis, group size on this rank) of the candidate split: a
    candidate-minor axis in groups of M', or the dense rows (scene, m,
    maneuver) in groups of 3 M'."""
    ax, m_local = _CAND[0]
    return (rows, 3 * m_local) if cands is None else (cands, m_local)


def candidate_part(x: Tensor, rows: int = 0,
                   cands: Optional[int] = None) -> Tensor:
    """This rank's candidates of ``x`` (already this rank's scenes) under
    the planner's candidate share: the candidate part of
    :func:`local_part`."""
    if _CAND[0] is None or _CAND[0][0].world == 1:
        return x
    ax = _CAND[0][0]
    dim, g = _cand_axis(rows, cands)
    return _take(x, dim, g, ax.rank, ax.world)


def local_part(x: Tensor, rows: int = 0,
               cands: Optional[int] = None) -> Tensor:
    """This rank's part of a whole tensor under the active shardings:
    axis ``rows`` (scene-major rows) split over the data axis; under
    candidate sharding the candidates split by seed index on axis
    ``cands`` (a candidate-minor R axis, r = j*M + m) or, with ``cands``
    None, on ``rows`` read as dense (scene, m, maneuver) rows.  The
    identity when no sharding is active."""
    d = _DATA[0]
    if d is not None and d.world > 1:
        x = _take(x, rows, x.shape[rows] // d.world, d.rank, d.world)
    return candidate_part(x, rows, cands)


def whole_shape(shape: Sequence[int], rows: int = 0,
                cands: Optional[int] = None) -> tuple:
    """The shape of the whole tensor whose :func:`local_part` is
    ``shape``."""
    s = list(shape)
    d = _DATA[0]
    if d is not None:
        s[rows] *= d.world
    if _CAND[0] is not None:
        s[_cand_axis(rows, cands)[0]] *= _CAND[0][0].world
    return tuple(s)


def draw(make, shape: Sequence[int], rows: int = 0,
         cands: Optional[int] = None) -> Tensor:
    """``make(whole_shape)``'s :func:`local_part`: a draw of this rank's
    ``shape`` that takes from the generator what the unsharded draw
    takes."""
    return local_part(make(whole_shape(shape, rows, cands)), rows, cands)


def constrain_candidates(x: Optional[Tensor], dim: int,
                         batch_dim: Optional[int] = None):
    """The sampler's hook (JAX's sharding constraint at the noise's
    creation): this rank's part of the whole ``x``.  ``batch_dim`` given:
    ``dim`` is a candidate-minor R axis and ``batch_dim`` the scenes;
    otherwise ``dim`` is the flat scene-major dense-row axis.  The identity
    with no sharding active."""
    if x is None:
        return x
    if batch_dim is None:
        return local_part(x, rows=dim)
    return local_part(x, rows=batch_dim, cands=dim)


def gather_candidates(x: Tensor, rows: int = 0,
                      cands: Optional[int] = None) -> Tensor:
    """Inverse of the candidate part of :func:`local_part`: every rank's
    candidates of ``x``, in their whole order."""
    if _CAND[0] is None or _CAND[0][0].world == 1:
        return x
    ax = _CAND[0][0]
    dim, g = _cand_axis(rows, cands)
    dim %= x.ndim
    s = x.shape
    parts = all_gather_cat(x[None], ax.group, 0)
    v = parts.reshape(ax.world, *s[:dim], s[dim] // g, g, *s[dim + 1:])
    v = torch.movedim(v, 0, dim + 1)
    return v.reshape(*s[:dim], s[dim] * ax.world, *s[dim + 1:])


def sharded() -> bool:
    """Whether a sharding context is entered: a data or candidate share,
    or the planner's ``candidate_sharding`` (world 1 too)."""
    return bool(_active()) or _CAND_MESH[0] is not None


def shard_world() -> int:
    """How many ranks share the rows under the active shardings (1 with
    none)."""
    return math.prod(a.world for a in _active())


def shard_mean(x: Tensor) -> Tensor:
    """``x``'s mean over the ranks of the active shardings (``x`` with
    none); for per-rank means over equal shards, the whole's mean."""
    for a in _active():
        if a.world > 1:
            x = all_reduce(x, a.group) / a.world
    return x


def shard_max(x: Tensor) -> Tensor:
    """``x``'s maximum over the ranks of the active shardings."""
    for a in _active():
        if a.world > 1:
            x = all_reduce(x, a.group, dist.ReduceOp.MAX)
    return x
