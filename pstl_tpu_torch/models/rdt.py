"""RDT-1B's diffusion transformer, the Robotics Diffusion Transformer (Liu et
al., ICLR 2025, arXiv:2410.07864; ``github.com/thu-ml/
RoboticsDiffusionTransformer``, ``models/rdt/blocks.py``, ``model.py`` and
the runner's adaptors), as an eps head of
:class:`pstl_tpu_torch.models.net.Net` (``models/eps_head``).

The modules and their parameter names are the published ones (the
runner's ``model``, ``lang_adaptor``, ``img_adaptor``, ``state_adaptor``),
so that a published state dict's blocks load.  The forward walks them
functionally on an :class:`RdtWeights`, cast once a net.

Layers, with D = ``hidden_size``, H heads of D / H and RMSNorm(x) = x /
sqrt(mean(x^2) + 1e-6) * w:

- tokens [tau_t; tau_f; tau_s; a_1 ... a_nt] + P_x (nt + 3 of width D,
  P_x a fixed 1-D sin-cos table).  tau_t and tau_f are two
  TimestepEmbedders (``[cos(t f_i); sin(t f_i)]``, f_i = exp(-ln 10000 i /
  128), i < 128, then Linear(256, D), SiLU, Linear(D, D)) of the timestep
  and of the control frequency ``freq_hz``.  tau_s and each a_k are
  ``state_adaptor([u; m])`` (Linear(2S, D), GELU(tanh), Linear(D, D),
  GELU(tanh), Linear(D, D)) of an S = ``state_token_dim``-slot vector u
  and its 0/1 mask m: the state token holds the ego encoder's 6 inputs
  (``net.ego_inputs``) in slots 0-5, action token k the noisy (omega, a)
  of step k in slots 6-7; one mask marks slots 0-7 on every token.
- two condition streams: the language stream, the row's rule (highlevel,
  stlp) as one token (``lang_adaptor``: Linear(7, D), GELU(tanh),
  Linear(D, D)), and the image stream, the scene feature's 7 tokens of
  32 (``img_adaptor``); each plus its own sin-cos table.
- block i (i < depth): x += SelfAttn(RMSNorm1(x)); x += CrossAttn(
  RMSNorm2(x), c_i); x += FFN(RMSNorm3(x)), c_i the stream
  ``STREAMS[i % 2]`` (language on even blocks, image on odd), FFN =
  Linear(D, D), GELU(tanh), Linear(D, D).  SelfAttn: [q; k; v] = h W_qkv
  + b split into H heads, q and k RMS-normalized over a head's channels
  (one weight shared by the heads: QK-norm), softmax(q k^T / sqrt(D / H))
  v, then W_proj + b.  CrossAttn: q = h W_q + b, [k; v] = c W_kv + b, the
  same QK-norm, softmax and projection.
- final layer: Linear(D, out) of GELU(tanh) of Linear(D, D) of RMSNorm,
  on every token; the last nt are epsilon.

Precision (the port's rule): every linear layer's operands in the compute
dtype with fp32 accumulation, its output rounded to it; the residual
stream, RMSNorm and QK-norm (their statistics and weights) in fp32;
attention through ``F.scaled_dot_product_attention`` on compute-dtype
q / k / v (its softmax in fp32); SiLU and GELU on the compute dtype's
values, in fp32 inside.

On the candidate-minor chain (:meth:`RdtRunner.cm_eps`) what does not
change over a plan's denoise steps is built once a plan
(:func:`condition`): both streams' adapted tokens and every
cross-attention layer's K and V, the frequency and state tokens and the
mask; each pass reads them.  Cross-attention against the image stream
folds a scene's rows into the query axis (its queries against the
scene's 7 keys): K and V are never copied a row.

``calls`` and ``rows`` count passes and the rows they ran, ``cond_builds``
the condition builds (a captured chain's replay adds the passes its
capture held; the build runs outside it, once a plan).
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.models import convert, eps_head
from pstl_tpu_torch.models.net import compute_dtype, ego_inputs

Tensor = torch.Tensor

#: passes and the rows they ran, and condition builds, since the last reset
calls = 0
rows = 0
cond_builds = 0

#: the condition stream block i cross-attends to: ``STREAMS[i % 2]``
STREAMS = ("lang", "img")
#: the unified vector's slots: the noisy (omega, a) from ``ACTION_SLOT``
#: (the ego inputs before it), ``USED_SLOTS`` in all
ACTION_SLOT, USED_SLOTS = 6, 8
#: the timestep embedders' sinusoid width
FREQ_DIM = 256


@dataclasses.dataclass(frozen=True)
class RdtSpec:
    """The widths of an RDT (the published ``configs/base.yaml``'s
    ``model.rdt`` and ``state_token_dim``), the adaptors' input widths
    (the planner's), the output width and the control frequency."""
    hidden_size: int = 2048
    depth: int = 28
    num_heads: int = 32
    state_token_dim: int = 128
    lang_in: int = 7
    img_in: int = 32
    out_dim: int = 2
    freq_hz: float = 2.0

    def build(self, cfg: Config, planner: eps_head.Planner):
        """The network for the planner's rows (``eps_head``): the rule as
        the language token, the scene feature's tokens as the image
        stream, epsilon of the 2 controls a step."""
        eps_head.check_route(cfg, RdtRunner.kind)
        if self.hidden_size % self.num_heads:
            raise ValueError(f"RDT: hidden_size {self.hidden_size} is not "
                             f"divisible by num_heads {self.num_heads}")
        if (self.lang_in, self.img_in) != (planner.rule_dim,
                                           planner.token_dim):
            raise ValueError(
                f"RDT: adaptor inputs (lang {self.lang_in}, img "
                f"{self.img_in}) must be the planner's rule "
                f"({planner.rule_dim}) and scene-token ({planner.token_dim})"
                " widths")
        if self.out_dim != 2 or self.state_token_dim < USED_SLOTS:
            raise ValueError("RDT: the planner's eps has 2 channels (out_dim "
                             f"2) and its tokens use {USED_SLOTS} slots")
        return RdtRunner(self, cfg.nt, planner.scene_tokens)


# --------------------------------------------------------------------------
# the published module tree
# --------------------------------------------------------------------------

class RmsNorm(nn.Module):
    """timm's ``RmsNorm``: x / sqrt(mean(x^2) + eps) * weight."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQ_DIM, hidden), nn.SiLU(),
                                 nn.Linear(hidden, hidden))


class Attention(nn.Module):
    """timm's ``Attention`` with ``qkv_bias`` and ``qk_norm`` (RmsNorm)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = RmsNorm(dim // heads)
        self.k_norm = RmsNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.q_norm = RmsNorm(dim // heads)
        self.k_norm = RmsNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    """timm's ``Mlp`` (``fc1``, GELU(tanh), ``fc2``)."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)


class RDTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = RmsNorm(dim)
        self.attn = Attention(dim, heads)
        self.cross_attn = CrossAttention(dim, heads)
        self.norm2 = RmsNorm(dim)
        self.ffn = Mlp(dim, dim, dim)
        self.norm3 = RmsNorm(dim)


class FinalLayer(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.norm_final = RmsNorm(dim)
        self.ffn_final = Mlp(dim, dim, out)


class RDT(nn.Module):
    """``models/rdt/model.py``'s ``RDT``: the embedders, the position
    tables (nt + 3 token positions, one language token, ``img_tokens``
    image tokens), the blocks and the final layer."""

    def __init__(self, spec: RdtSpec, nt: int, img_tokens: int):
        super().__init__()
        D = spec.hidden_size
        self.horizon = nt
        self.t_embedder = TimestepEmbedder(D)
        self.freq_embedder = TimestepEmbedder(D)
        self.x_pos_embed = nn.Parameter(torch.zeros(1, nt + 3, D))
        self.lang_cond_pos_embed = nn.Parameter(torch.zeros(1, 1, D))
        self.img_cond_pos_embed = nn.Parameter(torch.zeros(1, img_tokens, D))
        self.blocks = nn.ModuleList(RDTBlock(D, spec.num_heads)
                                    for _ in range(spec.depth))
        self.final_layer = FinalLayer(D, spec.out_dim)


def _adaptor(d_in: int, d_out: int, depth: int) -> nn.Sequential:
    """The runner's ``mlp{depth}x_gelu`` adaptor."""
    mods = [nn.Linear(d_in, d_out)]
    for _ in range(depth - 1):
        mods += [nn.GELU(approximate="tanh"), nn.Linear(d_out, d_out)]
    return nn.Sequential(*mods)


def sincos_table(positions: int, dim: int) -> Tensor:
    """The 1-D sin-cos table (positions, dim): [sin(p w_i); cos(p w_i)],
    w_i = 10000^(-i / (dim / 2)), computed in float64."""
    w = 1.0 / 10000.0 ** (torch.arange(dim // 2, dtype=torch.float64)
                          / (dim / 2.0))
    a = torch.arange(positions, dtype=torch.float64)[:, None] * w[None, :]
    return torch.cat([torch.sin(a), torch.cos(a)], dim=1).float()


class RdtRunner(eps_head.EpsHead):
    """The runner's modules: ``model`` (:class:`RDT`) and its three
    adaptors, the state adaptor reading ``[u; m]``."""
    kind = "RDT"

    def __init__(self, spec: RdtSpec, nt: int, img_tokens: int):
        super().__init__()
        D = spec.hidden_size
        self.spec = spec
        self.model = RDT(spec, nt, img_tokens)
        self.lang_adaptor = _adaptor(spec.lang_in, D, 2)
        self.img_adaptor = _adaptor(spec.img_in, D, 2)
        self.state_adaptor = _adaptor(2 * spec.state_token_dim, D, 3)

    # -- the eps head (``models/eps_head.EpsHead``) -------------------------
    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator) -> None:
        """RDT's ``initialize_weights``, drawn from ``generator`` in module
        order: every Linear xavier-uniform (the two embedders' normal with
        std 0.02) with a zero bias, RMSNorm weights 1, the position tables
        their sin-cos values.  One departure: the final layer's last
        Linear is drawn as the others, not zeroed (a zero layer makes
        every output 0)."""
        embedders = {id(m) for e in (self.model.t_embedder,
                                     self.model.freq_embedder)
                     for m in e.modules()}
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if id(m) in embedders:
                    nn.init.normal_(m.weight, std=0.02, generator=generator)
                else:
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, RmsNorm):
                nn.init.ones_(m.weight)
        for p in (self.model.x_pos_embed, self.model.lang_cond_pos_embed,
                  self.model.img_cond_pos_embed):
            p.copy_(sincos_table(p.shape[1], p.shape[2])[None])

    def weights(self, dt: torch.dtype) -> "RdtWeights":
        return convert.cast_once(self, (dt,), lambda: RdtWeights(self, dt))

    def rows(self, net, batch, feature, highlevel, stlp, noise, timestep):
        n = feature.shape[0]
        w = self.weights(compute_dtype(net.cfg))
        ego = ego_inputs(batch)
        cond = condition(self, w, ego.repeat_interleave(n // ego.shape[0], 0),
                         torch.cat([highlevel, stlp], -1),
                         feature.reshape(n, -1, self.spec.img_in))
        return denoise(self, w, cond, noise.reshape(n, -1, 2),
                       timestep.reshape(-1))

    def cm_eps(self, net, batch, highlevel, feature, stlp, cfg, M):
        R = 3 * M
        bs = feature.shape[0] // R
        w = self.weights(compute_dtype(cfg))
        rule = torch.cat([highlevel, stlp], -1)
        rule = rule.reshape(bs, M, 3, -1).transpose(1, 2).reshape(bs * R, -1)
        # the scene feature, tiled to a scene's rows (the planner's tiling):
        # its first row stands for all of them (``EpsHead.cm_eps``)
        scene = feature.reshape(bs, R, -1, self.spec.img_in)[:, 0]
        return cm_rdt_eps(condition(self, w, ego_inputs(batch), rule, scene),
                          self, w)


class RdtWeights:
    """What the forward reads of an :class:`RdtRunner`: by module, every
    Linear's (weight, bias) in ``dt`` and every RmsNorm's weight in fp32;
    the position tables (fp32) without their batch axis."""

    def __init__(self, runner: RdtRunner, dt: torch.dtype):
        self.dt = dt
        self.of: Dict[nn.Module, object] = {}
        for m in runner.modules():
            if isinstance(m, nn.Linear):
                self.of[m] = (m.weight.to(dt), m.bias.to(dt))
            elif isinstance(m, RmsNorm):
                self.of[m] = m.weight
        mdl = runner.model
        self.x_pos = mdl.x_pos_embed[0]
        self.lang_pos = mdl.lang_cond_pos_embed[0]
        self.img_pos = mdl.img_cond_pos_embed[0]


# --------------------------------------------------------------------------
# the forward
# --------------------------------------------------------------------------

def _lin(h: Tensor, m: nn.Linear, w: RdtWeights) -> Tensor:
    W, b = w.of[m]
    return F.linear(h, W, b)


def _rms(x: Tensor, m: RmsNorm, w: RdtWeights) -> Tensor:
    return F.rms_norm(x, (x.shape[-1],), w.of[m], m.eps)


def head_norm(x: Tensor, m: RmsNorm, w: RdtWeights) -> Tensor:
    """QK-norm: ``x`` (..., H, D / H) RMS-normalized over a head's
    channels in fp32, back in the compute dtype."""
    return _rms(x.float(), m, w).to(w.dt)


def _mlp(seq: nn.Sequential, h: Tensor, w: RdtWeights) -> Tensor:
    """An adaptor (or an embedder's MLP, whose activation is SiLU) on ``h``
    in the compute dtype; fp32 out."""
    for m in seq:
        if isinstance(m, nn.Linear):
            h = _lin(h, m, w)
        elif isinstance(m, nn.SiLU):
            h = F.silu(h)
        else:
            h = F.gelu(h, approximate="tanh")
    return h.float()


def timestep_features(t: Tensor) -> Tensor:
    """``TimestepEmbedder.timestep_embedding`` of ``t`` (k,): (k, 256)."""
    half = FREQ_DIM // 2
    f = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * f[None, :]
    return torch.cat([torch.cos(a), torch.sin(a)], dim=-1)


def _embed(e: TimestepEmbedder, t: Tensor, w: RdtWeights) -> Tensor:
    return _mlp(e.mlp, timestep_features(t).to(w.dt), w)


def _unified(values: Tensor, slot: int, mask: Tensor) -> Tensor:
    """[u; m] of ``values`` (..., k) placed at ``slot`` of the unified
    vector (the rest 0) and the mask (S,), in the mask's dtype."""
    S = mask.shape[0]
    u = F.pad(values.to(mask.dtype), (slot, S - slot - values.shape[-1]))
    return torch.cat([u, mask.expand(u.shape)], dim=-1)


def _cross_kv(blk: RDTBlock, c: Tensor, w: RdtWeights, heads: int):
    """K and V (B, H, Lc, D / H) of block ``blk``'s cross-attention over
    the condition tokens ``c`` (B, Lc, D) in fp32, K normalized."""
    B, Lc, D = c.shape
    kv = _lin(c.to(w.dt), blk.cross_attn.kv, w).view(B, Lc, 2, heads, -1)
    k, v = kv.unbind(2)
    k = head_norm(k, blk.cross_attn.k_norm, w)
    return k.transpose(1, 2), v.transpose(1, 2)


def condition(runner: RdtRunner, w: RdtWeights, ego: Tensor, rule: Tensor,
              scene: Tensor) -> Dict[str, Tensor]:
    """What the passes read that does not change over a plan: ``fixed``
    (B, 2, D), the frequency and state tokens with their positions (the
    state from ``ego`` (B, 6)); ``lang_kv`` (depth / 2, 2, n, H, 1, D / H)
    and ``img_kv`` (depth / 2, 2, Bi, H, T, D / H), each cross-attention
    layer's K and V by stream, in block order, over the language tokens
    of ``rule`` (n, 7) and the image tokens of ``scene`` (Bi, T, 32);
    ``mask`` (S,).  B and Bi divide the rows a pass runs: rows come
    grouped, n / B to a state token, n / Bi to a scene."""
    global cond_builds
    cond_builds += 1
    spec, mdl = runner.spec, runner.model
    dev = rule.device
    mask = torch.zeros(spec.state_token_dim, dtype=w.dt, device=dev)
    mask[:USED_SLOTS] = 1
    freq = _embed(mdl.freq_embedder,
                  torch.full((1,), float(spec.freq_hz), device=dev), w)
    state = _mlp(runner.state_adaptor, _unified(ego, 0, mask), w)
    fixed = torch.stack([(freq + w.x_pos[1]).expand_as(state),
                         state + w.x_pos[2]], dim=1)
    streams = {
        "lang": _mlp(runner.lang_adaptor, rule[:, None].to(w.dt), w)
        + w.lang_pos,
        "img": _mlp(runner.img_adaptor, scene.to(w.dt), w) + w.img_pos}
    kvs = {"lang": [], "img": []}
    for i, blk in enumerate(mdl.blocks):
        s = STREAMS[i % 2]
        kvs[s].append(torch.stack(_cross_kv(blk, streams[s], w,
                                            spec.num_heads)))
    return {"fixed": fixed, "mask": mask,
            **{f"{s}_kv": torch.stack(v) for s, v in kvs.items() if v}}


def _block_kv(cond: Dict[str, Tensor], i: int) -> Tuple[Tensor, Tensor]:
    kv = cond[STREAMS[i % 2] + "_kv"][i // 2]
    return kv[0], kv[1]


def _attend(x: Tensor, q: Tensor, k: Tensor, v: Tensor, proj: nn.Linear,
            w: RdtWeights) -> Tensor:
    """``x`` (n, L, D) plus the projection of the attention of ``q`` (n,
    L, H, D / H) to ``k`` and ``v`` (B, H, Lk, D / H): with B < n, the
    queries of n / B consecutive rows share a B-row of keys (one query
    axis of (n / B) L)."""
    n, L, D = x.shape
    B, H = k.shape[:2]
    q = q.reshape(B, (n // B) * L, H, -1).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k, v)
    return x + _lin(o.transpose(1, 2).reshape(n, L, D), proj, w)


def _block(x: Tensor, blk: RDTBlock, k: Tensor, v: Tensor, w: RdtWeights,
           heads: int) -> Tensor:
    n, L, D = x.shape
    at = blk.attn
    h = _rms(x, blk.norm1, w).to(w.dt)
    q, sk, sv = _lin(h, at.qkv, w).view(n, L, 3, heads, -1).unbind(2)
    x = _attend(x, head_norm(q, at.q_norm, w),
                head_norm(sk, at.k_norm, w).transpose(1, 2),
                sv.transpose(1, 2), at.proj, w)
    ca = blk.cross_attn
    h = _rms(x, blk.norm2, w).to(w.dt)
    q = _lin(h, ca.q, w).view(n, L, heads, -1)
    x = _attend(x, head_norm(q, ca.q_norm, w), k, v, ca.proj, w)
    h = _rms(x, blk.norm3, w).to(w.dt)
    h = F.gelu(_lin(h, blk.ffn.fc1, w), approximate="tanh")
    return x + _lin(h, blk.ffn.fc2, w)


def denoise(runner: RdtRunner, w: RdtWeights, cond: Dict[str, Tensor],
            x: Tensor, t: Tensor) -> Tensor:
    """Epsilon (n, nt, out) of the noisy controls ``x`` (n, nt, 2) at
    timesteps ``t`` ((n,), or (1,) for every row), on the plan's
    ``cond`` (:func:`condition`)."""
    global calls, rows
    mdl = runner.model
    n, nt = x.shape[:2]
    calls += 1
    rows += n
    D = runner.spec.hidden_size
    fixed = cond["fixed"]
    B = fixed.shape[0]
    tt = _embed(mdl.t_embedder, t, w) + w.x_pos[0]
    act = _mlp(runner.state_adaptor, _unified(x, ACTION_SLOT, cond["mask"]),
               w) + w.x_pos[3:]
    h = torch.cat([tt.reshape(-1, 1, 1, D).expand(B, n // B, 1, D)
                   if tt.shape[0] == 1 else tt.reshape(B, n // B, 1, D),
                   fixed[:, None].expand(B, n // B, 2, D),
                   act.reshape(B, n // B, nt, D)], dim=2).reshape(n, -1, D)
    for i, blk in enumerate(mdl.blocks):
        h = _block(h, blk, *_block_kv(cond, i), w, runner.spec.num_heads)
    fl = mdl.final_layer
    h = _rms(h, fl.norm_final, w).to(w.dt)
    h = F.gelu(_lin(h, fl.ffn_final.fc1, w), approximate="tanh")
    return _lin(h, fl.ffn_final.fc2, w)[:, -nt:].float()


def cm_rdt_eps(cond: Dict[str, Tensor], runner: RdtRunner, w: RdtWeights):
    """``eps_cm(x_cm (bs, nt, 2, R), t) -> eps`` of an RDT head on the
    plan's ``cond``: the candidates turned to rows (b * R + r, nt, 2), a
    pass, turned back; with what the chain's graph reads of it
    (``diffusion``; ``inputs`` the condition, ``counters`` the passes and
    rows)."""
    def eps_cm(x_cm: Tensor, t: int) -> Tensor:
        bs, nt, _, R = x_cm.shape
        x = x_cm.permute(0, 3, 1, 2).reshape(bs * R, nt, 2)
        te = torch.full((1,), float(t), device=x_cm.device)
        e = denoise(runner, w, cond, x, te)
        return e.reshape(bs, R, nt, 2).permute(0, 2, 3, 1).contiguous()

    me = sys.modules[__name__]
    eps_cm.weights = w
    eps_cm.inputs = dict(cond)
    eps_cm.on_base = lambda d: cm_rdt_eps(d, runner, w)
    eps_cm.counters = ((me, "calls"), (me, "rows"))
    return eps_cm
