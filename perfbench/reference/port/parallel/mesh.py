"""A frozen copy of ``pstl_tpu_torch/parallel/mesh.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

Tensor = torch.Tensor


class Axis(NamedTuple):
    """One mesh axis as this rank sees it."""
    group: object
    rank: int
    world: int


# ---------------------------------------------------------------------------
# collectives (the host for gloo)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# placements and batch sharding
# ---------------------------------------------------------------------------

_DATA: List[Optional[Axis]] = [None]       # the entered data sharding's
_CAND_MESH: List[Optional[Axis]] = [None]  # candidate_sharding's axis
_CAND: List = [None]                       # (Axis, M') in the planner


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


# ---------------------------------------------------------------------------
# the sharded program: whole draws sliced, counts over all ranks
# ---------------------------------------------------------------------------


def candidate_axis() -> Optional[Axis]:
    """The axis of the entered ``candidate_sharding``, or None."""
    return _CAND_MESH[0]


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


