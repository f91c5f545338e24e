"""The interface of an eps network that takes the diffusion head's place in
:class:`pstl_tpu_torch.models.net.Net` (``Net(cfg, eps_net=spec)``).

A spec (the network's widths, a frozen dataclass) has ``build(cfg,
planner)``: it refuses what the network cannot run (:func:`check_route`,
and its own shape rules) and returns the network, an :class:`EpsHead`
whose parameters keep their published names.  ``planner`` says what the
planner gives a candidate row besides its noisy controls and timestep:
the scene feature as ``scene_tokens`` tokens of ``token_dim``, and the
rule (highlevel and stlp) as ``rule_dim`` values.

Implementations: Diffusion Policy's ConditionalUnet1D
(``models/unet1d.py``) and RDT-1B's diffusion transformer
(``models/rdt.py``).  ``Net`` calls the head's methods and names neither.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn

from pstl_tpu_torch.config import Config

Tensor = torch.Tensor


class Planner(NamedTuple):
    """What the planner gives a candidate row: the scene feature as
    ``scene_tokens`` tokens of ``token_dim`` and the rule (highlevel,
    stlp) as ``rule_dim`` values."""
    scene_tokens: int
    token_dim: int
    rule_dim: int

    @property
    def cond_dim(self) -> int:
        """The width of a row's feature, highlevel and stlp together."""
        return self.scene_tokens * self.token_dim + self.rule_dim


def check_route(cfg: Config, kind: str) -> None:
    """Raise for what an eps network other than the eps MLP cannot run:
    the superstep kernel (kernel 5 embeds the eps MLP) and the init-hint
    input (an input block of the MLP's first layer).  ``kind`` names the
    network in the message."""
    if cfg.guidance_pallas_superstep:
        raise NotImplementedError(
            "guidance_pallas_superstep: the superstep kernel (kernel 5) "
            f"computes the eps MLP inside it; a {kind} eps head runs on the "
            "candidate-minor chain (guidance_pallas_superstep=False)")
    if cfg.use_init_hint:
        raise NotImplementedError(
            "use_init_hint: the init hint is an input block of the eps "
            f"MLP's first layer; a {kind} eps head has no such input")


class EpsHead(nn.Module):
    """An eps network in the diffusion head's place.  ``kind`` names it in
    refusals.  Epsilon is the network's output itself (no ``+ noise``
    residual: that is the eps MLP's)."""
    kind = "eps network"

    def check_route(self, cfg: Config) -> None:
        check_route(cfg, self.kind)

    def init_seeded(self, generator: torch.Generator) -> None:
        """Fresh parameters from ``generator``, in module order."""
        raise NotImplementedError

    def weights(self, dt: torch.dtype):
        """What a forward reads of the parameters, cast to ``dt`` and laid
        out once while they stay (``convert.cast_once``); the chain's
        graphs are keyed on it."""
        raise NotImplementedError

    def rows(self, net: nn.Module, batch: Dict[str, Tensor],
             feature: Tensor, highlevel: Tensor, stlp: Tensor,
             noise: Tensor, timestep: Tensor) -> Tensor:
        """Epsilon (n, nt, 2) of the row-major rows: ``feature`` (n, F),
        ``highlevel`` (n, 1), ``stlp`` (n, 6), ``noise`` (n, nt * 2) and
        ``timestep`` (n, 1) a row; ``batch`` the scenes' (n // bs rows a
        scene, in order), ``net`` the ``Net`` holding this head."""
        raise NotImplementedError

    def cm_eps(self, net: nn.Module, batch: Dict[str, Tensor],
               highlevel: Tensor, feature: Tensor, stlp: Tensor,
               cfg: Config, M: int):
        """``eps_cm(x_cm (bs, nt, 2, R), t) -> eps`` of the candidate-minor
        chain (R = 3 M, r = j * M + m of scene b is row b * 3M + m * 3 + j
        of ``feature``, ``highlevel``, ``stlp``; every row of a scene
        carries the scene's feature, as the planner tiles it, and a head
        may read a scene's first row for all of them), with what the
        chain's graph reads of it (``diffusion``): ``weights`` (its key),
        ``inputs`` (the tensors a plan makes fresh, by name),
        ``on_base(d)`` (the same function reading them from ``d``) and
        ``counters`` ((module, name) of the counters a capture holds)."""
        raise NotImplementedError
