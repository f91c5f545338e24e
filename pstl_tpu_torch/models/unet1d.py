"""ConditionalUnet1D, Diffusion Policy's epsilon network (Chi et al., RSS
2023; ``diffusion_policy/model/diffusion/conditional_unet1d.py``), as an
eps head of :class:`pstl_tpu_torch.models.net.Net` (``models/eps_head``):
it reads the noisy controls as 2 channels over the nt steps, the timestep
through its own step encoder and the rest of the eps MLP's input (scene
feature, highlevel, stlp) as its global condition.

The modules and their parameter names are the published ones, so a
published state dict loads.  The forward (:func:`forward`) walks them
functionally on a :class:`UnetWeights`, which holds every convolution and
linear weight and bias in the compute dtype, cast once a net, and the
GroupNorm affine parameters in fp32.  The port's precision rule:
convolution and linear operands in the compute dtype with fp32
accumulation, their outputs rounded to the compute dtype; a block
convolution's bias, GroupNorm (its statistics), Mish, FiLM and the residual
sums in fp32.

Inside :func:`forward` the activations are channels-last, (n, L, C)
contiguous, and each convolution is a 2-D one on the view (n, C, 1, L) in
``torch.channels_last``, which cuDNN's NHWC kernels take and give without
a transpose.  Between two convolutions one pass
(``ops/unet1d_norm.norm_mish``: a hand-written CUDA kernel on the card)
adds the bias, normalizes, applies Mish and the FiLM or the residual sum
and writes the next convolution's input.

Layers, with cond ``c`` (n, cond_dim):

- ``Conv1dBlock(ci, co, k)``: Conv1d(ci, co, k, padding k//2), GroupNorm
  (n_groups, co), Mish.
- ``ConditionalResidualBlock1D(ci, co)``: h = Conv1dBlock(ci, co)(x);
  [s; b] = Linear(cond_dim, 2 co)(Mish(c)); h = s * h + b (FiLM, under
  ``cond_predict_scale``; else h + Linear(cond_dim, co)(Mish(c)));
  h = Conv1dBlock(co, co)(h); out = h + (Conv1d(ci, co, 1)(x) if ci != co
  else x).
- step encoder: sinusoidal(E) (half E/2, frequencies exp(-i ln 10000 /
  (E/2 - 1)), sin then cos), Linear(E, 4E), Mish, Linear(4E, E); c is the
  step embedding followed by the global condition.
- down path: per level two residual blocks (the first widens), its output
  kept as a skip, then Conv1d(d, d, 3, stride 2, pad 1) on every level
  but the last; two residual blocks at the widest; the up path reads the
  skips back from the deepest (the shallowest is never read, as
  published), each level two residual blocks on [x; skip] and a
  ConvTranspose1d(d, d, 4, 2, 1); Conv1dBlock and a 1x1 Conv1d to the
  input channels.  The output is epsilon itself.

``calls`` and ``rows`` count forward passes and the rows they ran (a
captured chain's replay adds the count its capture held).
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
from pstl_tpu_torch.models.net import compute_dtype
from pstl_tpu_torch.ops import unet1d_norm

Tensor = torch.Tensor

#: forward passes, and the rows they ran, since the last reset
calls = 0
rows = 0


@dataclasses.dataclass(frozen=True)
class UnetSpec:
    """The widths of a ConditionalUnet1D (the published constructor's
    arguments; the defaults are the low-dim U-Net workspace configs')."""
    down_dims: Tuple[int, ...] = (256, 512, 1024)
    kernel_size: int = 5
    n_groups: int = 8
    step_embed_dim: int = 256
    cond_predict_scale: bool = True

    def __post_init__(self):
        object.__setattr__(self, "down_dims", tuple(self.down_dims))

    @property
    def stride(self) -> int:
        """What the horizon must be divisible by: one halving a level but
        the last."""
        return 2 ** (len(self.down_dims) - 1)

    def build(self, cfg: Config, planner: eps_head.Planner):
        """The network for the planner's rows (``eps_head``): 2 channels,
        the rows' feature, highlevel and stlp as the global condition."""
        eps_head.check_route(cfg, ConditionalUnet1D.kind)
        check_horizon(self, cfg.nt)
        return ConditionalUnet1D(2, planner.cond_dim, self)


def check_horizon(spec: UnetSpec, nt: int) -> None:
    if nt % spec.stride:
        raise ValueError(f"ConditionalUnet1D with down_dims {spec.down_dims} "
                         f"halves the horizon {len(spec.down_dims) - 1} "
                         f"times: nt ({nt}) must be divisible by "
                         f"{spec.stride}")


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: Tensor) -> Tensor:
        half = self.dim // 2
        f = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                      * -(math.log(10000) / (half - 1)))
        ang = t.float()[:, None] * f[None, :]
        return torch.cat([ang.sin(), ang.cos()], dim=-1)


class Conv1dBlock(nn.Module):
    def __init__(self, ci: int, co: int, k: int, n_groups: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv1d(ci, co, k, padding=k // 2),
                                   nn.GroupNorm(n_groups, co), nn.Mish())


class ConditionalResidualBlock1D(nn.Module):
    def __init__(self, ci: int, co: int, cond_dim: int, spec: UnetSpec):
        super().__init__()
        k, g = spec.kernel_size, spec.n_groups
        self.blocks = nn.ModuleList([Conv1dBlock(ci, co, k, g),
                                     Conv1dBlock(co, co, k, g)])
        self.co = co
        self.scale = spec.cond_predict_scale
        self.cond_encoder = nn.Sequential(
            nn.Mish(), nn.Linear(cond_dim, 2 * co if self.scale else co))
        self.residual_conv = nn.Conv1d(ci, co, 1) if ci != co \
            else nn.Identity()


class Downsample1d(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)


class Upsample1d(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)


class ConditionalUnet1D(eps_head.EpsHead):
    """The published module tree (``input_dim`` channels in and out, a
    global condition of ``global_cond_dim``); :func:`forward` runs it."""
    kind = "ConditionalUnet1D"

    def __init__(self, input_dim: int, global_cond_dim: int,
                 spec: UnetSpec):
        super().__init__()
        self.spec = spec
        E = spec.step_embed_dim
        cond_dim = E + global_cond_dim
        self.diffusion_step_encoder = nn.Sequential(
            SinusoidalPosEmb(E), nn.Linear(E, 4 * E), nn.Mish(),
            nn.Linear(4 * E, E))
        dims = [input_dim] + list(spec.down_dims)
        in_out = list(zip(dims[:-1], dims[1:]))
        self.down_modules = nn.ModuleList(
            nn.ModuleList([
                ConditionalResidualBlock1D(a, b, cond_dim, spec),
                ConditionalResidualBlock1D(b, b, cond_dim, spec),
                Downsample1d(b) if i < len(in_out) - 1 else nn.Identity()])
            for i, (a, b) in enumerate(in_out))
        mid = dims[-1]
        self.mid_modules = nn.ModuleList(
            ConditionalResidualBlock1D(mid, mid, cond_dim, spec)
            for _ in range(2))
        self.up_modules = nn.ModuleList(
            nn.ModuleList([
                ConditionalResidualBlock1D(2 * b, a, cond_dim, spec),
                ConditionalResidualBlock1D(a, a, cond_dim, spec),
                Upsample1d(a)])
            for a, b in reversed(in_out[1:]))
        start = spec.down_dims[0]
        self.final_conv = nn.Sequential(
            Conv1dBlock(start, start, spec.kernel_size, spec.n_groups),
            nn.Conv1d(start, input_dim, 1))

    # -- the eps head (``models/eps_head.EpsHead``) -------------------------
    def init_seeded(self, generator: torch.Generator) -> None:
        init_torch_default(self, generator)

    def weights(self, dt: torch.dtype) -> "UnetWeights":
        return unet_weights(self, dt)

    def rows(self, net, batch, feature, highlevel, stlp, noise, timestep):
        nt = noise.shape[-1] // 2
        eps = forward(self, self.weights(compute_dtype(net.cfg)),
                      noise.reshape(-1, nt, 2).transpose(1, 2),
                      timestep.reshape(-1),
                      torch.cat([feature, highlevel, stlp], -1))
        return eps.transpose(1, 2)

    def cm_eps(self, net, batch, highlevel, feature, stlp, cfg, M):
        R = 3 * M
        bs = feature.shape[0] // R
        g = torch.cat([feature, highlevel, stlp], -1)
        g_cm = g.reshape(bs, M, 3, -1).transpose(1, 2).reshape(bs * R, -1)
        return cm_unet_eps(g_cm, self, self.weights(compute_dtype(cfg)), R)


_AFFINE = (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)


@torch.no_grad()
def init_torch_default(net: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default initialization, which the published code keeps,
    drawn from ``generator`` in module order: every Conv1d,
    ConvTranspose1d and Linear weight uniform in +-1/sqrt(fan_in)
    (kaiming-uniform with a = sqrt(5)), then its bias in the same bound;
    GroupNorm's scale 1 and shift 0."""
    for m in net.modules():
        if isinstance(m, _AFFINE):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class UnetWeights:
    """What :func:`forward` reads of a :class:`ConditionalUnet1D`: by
    module, (weight, bias) of every convolution and linear layer in ``dt``
    and of every GroupNorm in fp32.  A convolution's weight is laid out
    once for the channels-last walk: (Co, Ci, k) as (Co, Ci, 1, k), a
    transposed one's (Ci, Co, k) as (Ci, Co, 1, k), in
    ``torch.channels_last``."""

    def __init__(self, net: ConditionalUnet1D, dt: torch.dtype):
        self.dt = dt
        self.of: Dict[nn.Module, Tuple[Tensor, Tensor]] = {}
        for m in net.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                self.of[m] = (m.weight.to(dt)[:, :, None, :].contiguous(
                    memory_format=torch.channels_last), m.bias.to(dt))
            elif isinstance(m, nn.Linear):
                self.of[m] = (m.weight.to(dt), m.bias.to(dt))
            elif isinstance(m, nn.GroupNorm):
                self.of[m] = (m.weight, m.bias)


def unet_weights(net: ConditionalUnet1D, dt: torch.dtype) -> UnetWeights:
    """The net's :class:`UnetWeights`, made once while its parameters stay
    (``convert.cast_once``)."""
    return convert.cast_once(net, (dt,), lambda: UnetWeights(net, dt))


def _conv(h: Tensor, m: nn.Module, w: UnetWeights,
          bias: bool = True) -> Tensor:
    """The convolution ``m`` of channels-last ``h`` (n, L, Ci) in the
    compute dtype: (n, L', Co), run as a 2-D convolution on the
    channels-last view (n, Ci, 1, L) so that cuDNN takes and gives NHWC
    as it is; its bias only where ``bias``."""
    W, b = w.of[m]
    n, L, C = h.shape
    op = F.conv_transpose2d if isinstance(m, nn.ConvTranspose1d) \
        else F.conv2d
    y = op(h.view(n, 1, L, C).permute(0, 3, 1, 2), W, b if bias else None,
           stride=(1, m.stride[0]), padding=(0, m.padding[0]))
    return y.permute(0, 2, 3, 1).reshape(n, y.shape[-1], y.shape[1])


def _block(h: Tensor, blk: Conv1dBlock, w: UnetWeights, **epilogue):
    """A Conv1dBlock on channels-last ``h``: its convolution without the
    bias, then :func:`unet1d_norm.norm_mish` (bias, GroupNorm, Mish and the
    ``epilogue``'s FiLM or residual).  Returns (the compute dtype's
    output, its fp32 copy or None)."""
    conv, gn = blk.block[0], blk.block[1]
    g, b = w.of[gn]
    return unet1d_norm.norm_mish(_conv(h, conv, w, bias=False), w.of[conv][1],
                                 g, b, gn.num_groups, gn.eps, **epilogue)


def _identity_input(m) -> bool:
    """Whether ``m`` adds its input unchanged as its residual."""
    return isinstance(m, ConditionalResidualBlock1D) \
        and isinstance(m.residual_conv, nn.Identity)


def _res(h: Tensor, h32, rb: ConditionalResidualBlock1D, mc: Tensor,
         w: UnetWeights, nxt=None):
    """A residual block on channels-last ``h`` in the compute dtype and
    ``mc`` = Mish(cond) in it; ``h32`` is ``h`` in fp32 where a residual
    block made it (else ``h`` is a convolution's output or a concatenation
    of them, exact in the compute dtype).  Returns (out, out in fp32 where
    ``nxt``, the module that reads it, adds it as its identity residual,
    else None)."""
    W, b = w.of[rb.cond_encoder[1]]
    a, _ = _block(h, rb.blocks[0], w, film=F.linear(mc, W, b),
                  film_scale=rb.scale)
    if isinstance(rb.residual_conv, nn.Identity):
        res = dict(res=h32 if h32 is not None else h.float())
    else:
        res = dict(res=_conv(h, rb.residual_conv, w, bias=False),
                   res_bias=w.of[rb.residual_conv][1])
    return _block(a, rb.blocks[1], w, **res, stream32=_identity_input(nxt))


def _linear(x: Tensor, m: nn.Linear, w: UnetWeights) -> Tensor:
    W, b = w.of[m]
    return (x.to(w.dt) @ W.t() + b).float()


def step_embedding(net: ConditionalUnet1D, t: Tensor,
                   w: UnetWeights) -> Tensor:
    """The step encoder on timesteps ``t`` (k,): (k, step_embed_dim)."""
    enc = net.diffusion_step_encoder
    h = F.mish(_linear(enc[0](t), enc[1], w))
    return _linear(h, enc[3], w)


def forward(net: ConditionalUnet1D, w: UnetWeights, x: Tensor, t: Tensor,
            g: Tensor) -> Tensor:
    """Epsilon (n, C, L) of ``x`` (n, C, L) at timesteps ``t`` ((n,), or
    (1,) for all rows) under the global condition ``g`` (n, G).  Inside,
    the activations are channels-last (n, L, C) in the compute dtype."""
    global calls, rows
    check_horizon(net.spec, x.shape[-1])
    calls += 1
    rows += x.shape[0]
    n = x.shape[0]
    ct = step_embedding(net, t, w).expand(n, -1)
    mc = F.mish(torch.cat([ct, g.float()], dim=-1)).to(w.dt)
    h = x.transpose(1, 2).to(dtype=w.dt, memory_format=torch.contiguous_format)
    h32 = None
    skips = []
    mids = list(net.mid_modules)
    for res1, res2, down in net.down_modules:
        last = isinstance(down, nn.Identity)
        h, h32 = _res(h, h32, res1, mc, w, res2)
        h, h32 = _res(h, h32, res2, mc, w, mids[0] if last and mids else None)
        skips.append(h)
        if not last:
            h, h32 = _conv(h, down.conv, w), None
    for i, res in enumerate(mids):
        h, h32 = _res(h, h32, res, mc, w, mids[i + 1] if i + 1 < len(mids)
                      else None)
    for res1, res2, up in net.up_modules:
        h = torch.cat([h, skips.pop()], dim=-1)
        h, h32 = _res(h, None, res1, mc, w, res2)
        h, _ = _res(h, h32, res2, mc, w)
        h = _conv(h, up.conv, w)
    h, _ = _block(h, net.final_conv[0], w)
    return _conv(h, net.final_conv[1], w).float().transpose(1, 2)


def cm_unet_eps(g_cm: Tensor, unet: ConditionalUnet1D, w: UnetWeights,
                R: int):
    """``eps_cm(x_cm (bs, nt, 2, R), t) -> eps`` of a ConditionalUnet1D
    head: the candidates turned to rows (b * R + r, 2, nt), the U-Net on
    them with the condition ``g_cm`` (bs * R, G) laid out alike and the
    step's timestep, turned back; with what the chain's graph reads of it
    (``diffusion``; ``inputs`` {"g"}, ``counters`` the U-Net's passes and
    rows and its epilogue kernel's launches)."""
    def eps_cm(x_cm: Tensor, t: int) -> Tensor:
        bs, nt = x_cm.shape[:2]
        x = x_cm.permute(0, 3, 2, 1).reshape(bs * R, 2, nt)
        te = torch.full((1,), float(t), device=x_cm.device)
        e = forward(unet, w, x, te, g_cm)
        return e.reshape(bs, R, 2, nt).permute(0, 3, 2, 1).contiguous()

    eps_cm.weights = w
    eps_cm.inputs = {"g": g_cm}
    eps_cm.on_base = lambda d: cm_unet_eps(d["g"], unet, w, R)
    eps_cm.counters = ((sys.modules[__name__], "calls"),
                       (sys.modules[__name__], "rows"),
                       (unet1d_norm, "launches"))
    return eps_cm
