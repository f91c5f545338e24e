"""The plain reference of ConditionalUnet1D (Diffusion Policy, Chi et al.,
RSS 2023; ``diffusion_policy/model/diffusion/conditional_unet1d.py``) as
the eps network of the frozen reference planner (``port/``).

Written from the published equations in plain ``torch`` operations: Mish
as x * tanh(softplus(x)), GroupNorm from its mean and biased variance, the
sinusoidal step embedding, every convolution a ``conv1d`` /
``conv_transpose1d`` call; no cache, no batching trick (the step encoder
runs on every row).  In float32 (the caller turns TF32 off), or with every
convolution and linear operand cast to a lower precision
(``port.models.net.cast``: bfloat16, or the control's float8 e4m3) and
the rest in float32.  Parameters are drawn here from a seed, with
PyTorch's default initialization (the published code's) and the frozen
encoders' flax-like one, in the program's order, so that the program's
net and this one hold the same numbers without reading each other.

:func:`attach` puts a U-Net on a frozen ``Net``; :func:`install` makes the
frozen planner's ``make_cm_eps_fn`` run it for such a net (every other net
keeps the frozen eps MLP).  The departure from the published model, kept
by the program too: epsilon is the output itself, with the global
condition the frozen planner's rows give (scene feature, highlevel,
stlp).  Imports nothing of the program, ``jax`` or the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.port.models import net as frozen

Tensor = torch.Tensor

#: the frozen Net's encoders, drawn in this order before the U-Net
ENCODERS = ("ego_encoder", "neighbor_encoder", "lane_encoder")


def _res_shapes(pre: str, ci: int, co: int, cond: int, k: int,
                scale: bool) -> List[Tuple[str, tuple]]:
    out = [(pre + ".blocks.0.block.0", (co, ci, k)),
           (pre + ".blocks.0.block.1", (co,)),
           (pre + ".blocks.1.block.0", (co, co, k)),
           (pre + ".blocks.1.block.1", (co,)),
           (pre + ".cond_encoder.1", (2 * co if scale else co, cond))]
    if ci != co:
        out.append((pre + ".residual_conv", (co, ci, 1)))
    return out


def layers(spec: dict, in_dim: int, global_dim: int):
    """(name, weight shape) of every parameterized layer, in the order the
    program's module tree lists them; a 1-d shape is a GroupNorm's."""
    E, k = spec["step_embed_dim"], spec["kernel_size"]
    scale = spec["cond_predict_scale"]
    cond = E + global_dim
    dims = [in_dim] + list(spec["down_dims"])
    pairs = list(zip(dims[:-1], dims[1:]))
    out = [("diffusion_step_encoder.1", (4 * E, E)),
           ("diffusion_step_encoder.3", (E, 4 * E))]
    for i, (a, b) in enumerate(pairs):
        out += _res_shapes(f"down_modules.{i}.0", a, b, cond, k, scale)
        out += _res_shapes(f"down_modules.{i}.1", b, b, cond, k, scale)
        if i < len(pairs) - 1:
            out.append((f"down_modules.{i}.2.conv", (b, b, 3)))
    for i in range(2):
        out += _res_shapes(f"mid_modules.{i}", dims[-1], dims[-1], cond, k,
                           scale)
    for i, (a, b) in enumerate(reversed(pairs[1:])):
        out += _res_shapes(f"up_modules.{i}.0", 2 * b, a, cond, k, scale)
        out += _res_shapes(f"up_modules.{i}.1", a, a, cond, k, scale)
        # ConvTranspose1d's weight is (in, out, k)
        out.append((f"up_modules.{i}.2.conv", (a, a, 4)))
    s = dims[1]
    out += [("final_conv.0.block.0", (s, s, k)),
            ("final_conv.0.block.1", (s,)),
            ("final_conv.1", (in_dim, s, 1))]
    return out


def draw(spec: dict, in_dim: int, global_dim: int,
         generator: torch.Generator) -> Dict[str, Tensor]:
    """Every parameter, by its published name: each weight uniform in
    +-1/sqrt(fan_in) (fan_in = the weight's size over its first dimension,
    as PyTorch counts it for convolutions, transposed ones included, and
    linear layers) and then its bias in the same bound; GroupNorm 1 and
    0."""
    p = {}
    for name, shape in layers(spec, in_dim, global_dim):
        if len(shape) == 1:
            p[name + ".weight"] = torch.ones(shape)
            p[name + ".bias"] = torch.zeros(shape)
            continue
        fan_in = math.prod(shape[1:])
        w = torch.empty(shape)
        torch.nn.init.kaiming_uniform_(w, a=math.sqrt(5), generator=generator)
        bound = 1.0 / math.sqrt(fan_in)
        p[name + ".weight"] = w
        p[name + ".bias"] = torch.empty(shape[0]).uniform_(
            -bound, bound, generator=generator)
    return p


def draw_encoders(net, generator: torch.Generator) -> None:
    """The frozen net's encoders as flax's ``Dense`` draws them: a normal
    truncated to +-2, scaled to variance 1/fan_in, zero bias; layer by
    layer in :data:`ENCODERS`' order."""
    with torch.no_grad():
        for enc in ENCODERS:
            for layer in getattr(net, enc).layers:
                w = layer.weight
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                            generator=generator)
                w.mul_(math.sqrt(1.0 / w.shape[1]) / frozen._TRUNC_STD)
                layer.bias.zero_()


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def mish(x: Tensor) -> Tensor:
    return x * torch.tanh(F.softplus(x))


def group_norm(x: Tensor, groups: int, w: Tensor, b: Tensor,
               eps: float = 1e-5) -> Tensor:
    n, c, L = x.shape
    g = x.reshape(n, groups, -1)
    mu = g.mean(-1, keepdim=True)
    var = ((g - mu) ** 2).mean(-1, keepdim=True)
    y = ((g - mu) / torch.sqrt(var + eps)).reshape(n, c, L)
    return y * w[None, :, None] + b[None, :, None]


def sinusoidal(t: Tensor, dim: int) -> Tensor:
    half = dim // 2
    i = torch.arange(half, dtype=torch.float32, device=t.device)
    f = torch.exp(i * (-math.log(10000.0) / (half - 1)))
    a = t.float()[:, None] * f[None, :]
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)


def forward(p: Dict[str, Tensor], spec: dict, x: Tensor, t: Tensor,
            g: Tensor, dt=torch.float32) -> Tensor:
    """Epsilon (n, C, L) of ``x`` (n, C, L) at timesteps ``t`` (n,) under
    the global condition ``g`` (n, G); convolution and linear operands in
    ``dt`` (``frozen.cast``), everything else in float32."""
    k, G = spec["kernel_size"], spec["n_groups"]

    def c(v):
        return frozen.cast(v, dt)

    def conv(h, name, stride=1, pad=0, transposed=False):
        f = F.conv_transpose1d if transposed else F.conv1d
        return f(c(h), c(p[name + ".weight"]), c(p[name + ".bias"]),
                 stride=stride, padding=pad).float()

    def linear(h, name):
        return (c(h) @ c(p[name + ".weight"]).t()
                + c(p[name + ".bias"])).float()

    def block(h, name):
        h = conv(h, name + ".block.0", pad=k // 2)
        return mish(group_norm(h, G, p[name + ".block.1.weight"],
                               p[name + ".block.1.bias"]))

    def res(h, name, cond):
        out = block(h, name + ".blocks.0")
        e = linear(mish(cond), name + ".cond_encoder.1")[..., None]
        co = out.shape[1]
        if spec["cond_predict_scale"]:
            out = e[:, :co] * out + e[:, co:]
        else:
            out = out + e
        out = block(out, name + ".blocks.1")
        skip = conv(h, name + ".residual_conv") \
            if name + ".residual_conv.weight" in p else h
        return out + skip

    te = sinusoidal(t, spec["step_embed_dim"])
    te = linear(mish(linear(te, "diffusion_step_encoder.1")),
                "diffusion_step_encoder.3")
    cond = torch.cat([te, g.float()], dim=-1)
    n_levels = len(spec["down_dims"])
    h = x.float()
    skips = []
    for i in range(n_levels):
        h = res(res(h, f"down_modules.{i}.0", cond),
                f"down_modules.{i}.1", cond)
        skips.append(h)
        if i < n_levels - 1:
            h = conv(h, f"down_modules.{i}.2.conv", stride=2, pad=1)
    for i in range(2):
        h = res(h, f"mid_modules.{i}", cond)
    for i in range(n_levels - 1):
        h = torch.cat([h, skips.pop()], dim=1)
        h = res(res(h, f"up_modules.{i}.0", cond), f"up_modules.{i}.1", cond)
        h = conv(h, f"up_modules.{i}.2.conv", stride=2, pad=1,
                 transposed=True)
    return conv(block(h, "final_conv.0"), "final_conv.1")


# ---------------------------------------------------------------------------
# the frozen planner's eps function
# ---------------------------------------------------------------------------

class Unet:
    """A U-Net on a frozen net: its parameters (moved to the rows' device
    on first use), its widths, where set the precision that overrides the
    configuration's ``compute_dtype``, and ``made``: the eps functions
    made on it, one a plan, in order (what a check reads back)."""

    def __init__(self, params: Dict[str, Tensor], spec: dict, dt=None):
        self.params, self.spec, self.dt = params, spec, dt
        self.made: List = []

    def on(self, dev) -> Dict[str, Tensor]:
        if next(iter(self.params.values())).device != dev:
            self.params = {k: v.to(dev) for k, v in self.params.items()}
        return self.params


def attach(net, spec: dict, seed: int, dt=None):
    """Draw ``net``'s encoders and a U-Net from ``seed`` (a CPU generator,
    in the program's order) and put the U-Net on ``net``; returns it."""
    g = torch.Generator().manual_seed(int(seed))
    draw_encoders(net, g)
    global_dim = 7 * frozen.Net.FEAT_DIM + 1 + frozen.Net.STLP_DIM
    net.unet = Unet(draw(spec, 2, global_dim, g), spec, dt)
    return net


def condition(feature: Tensor, highlevel: Tensor, stlp: Tensor) -> Tensor:
    """The global condition of each row: feature, highlevel, stlp."""
    return torch.cat([feature, highlevel, stlp], dim=-1)


def make_cm_eps_fn(net, batch: Dict[str, Tensor], highlevel: Tensor,
                   feature: Tensor, cfg, n_randoms: Optional[int] = None):
    """The frozen planner's ``eps_cm(x_cm (bs, nt, 2, R), t)`` for a net
    with a U-Net: candidate column r = j * M + m of scene b is row
    b * 3M + m * 3 + j of the feature (the planner's tiling), where the
    U-Net runs, and back."""
    u = net.unet
    M = n_randoms if n_randoms is not None else cfg.n_randoms
    bs = feature.shape[0] // (3 * M)
    g = condition(feature, highlevel, batch["stlp_dense"][:, 0])
    dt = u.dt if u.dt is not None else frozen.compute_dtype(cfg)

    def eps_cm(x_cm: Tensor, t: int) -> Tensor:
        nt = x_cm.shape[1]
        x = x_cm.reshape(bs, nt, 2, 3, M).permute(0, 4, 3, 2, 1)
        x = x.reshape(bs * 3 * M, 2, nt)
        ts = torch.full((x.shape[0],), float(t), device=x.device)
        e = forward(u.on(x.device), u.spec, x, ts, g, dt)
        e = e.reshape(bs, M, 3, 2, nt).permute(0, 4, 3, 2, 1)
        return e.reshape(bs, nt, 2, 3 * M)

    u.made.append(eps_cm)
    return eps_cm


def install() -> None:
    """Make the frozen planner's ``make_cm_eps_fn`` run :func:`
    make_cm_eps_fn` for a net with a U-Net, the frozen one for any other
    (idempotent; the frozen files stay as they are)."""
    if getattr(frozen.make_cm_eps_fn, "runs_unet", False):
        return
    mlp = frozen.make_cm_eps_fn

    def dispatch(net, *a, **kw):
        if getattr(net, "unet", None) is not None:
            return make_cm_eps_fn(net, *a, **kw)
        return mlp(net, *a, **kw)

    dispatch.runs_unet = True
    frozen.make_cm_eps_fn = dispatch
