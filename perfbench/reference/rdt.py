"""The plain reference of RDT-1B's diffusion transformer (Liu et al., ICLR
2025, arXiv:2410.07864; ``github.com/thu-ml/RoboticsDiffusionTransformer``
``models/rdt/blocks.py``, ``models/rdt/model.py`` and the runner's
adaptors) as the eps network of the frozen reference planner (``port/``).

Written from the published equations in plain ``torch`` operations: RMSNorm
as x * rsqrt(mean(x^2) + 1e-6) * w, GELU from its tanh formula, SiLU as x
sigmoid(x), attention as an explicit softmax of q k^T / sqrt(d) times v;
no cache, no folding, no batching trick: every row carries its own
condition tokens, recomputed on every pass, and its own embedders, and the
rows run in blocks of :data:`BLOCK_ROWS`.  In float32 (the caller turns
TF32 off), or with every matmul operand cast to a lower precision
(``port.models.net.cast``: bfloat16, or the control's float8 e4m3) and
the rest in float32.  Parameters are drawn here from a seed, as RDT's
``initialize_weights`` draws them (xavier-uniform Linears, the two
embedders normal with std 0.02, zero biases, RMSNorm 1, sin-cos position
tables), after the frozen encoders' flax-like draw, in the program's
order, so that the program's net and this one hold the same numbers
without reading each other.

The mapping onto the planner (the configuration's ``assumed``): tokens [t;
control frequency; state; nt actions], the state token the ego encoder's
6 inputs in slots 0-5 of the unified vector, action token k the noisy
(omega, a) of step k in slots 6-7, one mask over slots 0-7; the language
stream the row's highlevel and stlp as one token, the image stream the
scene feature's 7 tokens of 32; epsilon the last nt tokens' output.
The final layer's last Linear is drawn, not zeroed, as the program does.

:func:`attach` puts an RDT on a frozen ``Net``; :func:`install` makes the
frozen planner's ``make_cm_eps_fn`` run it for such a net (every other net
keeps what ran before).  Imports nothing of the program, ``jax`` or the
JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from perfbench.reference import unet1d as ref_unet
from perfbench.reference.port.models import net as frozen

Tensor = torch.Tensor

#: rows a block of the forward runs
BLOCK_ROWS = 64
#: slots of the unified vector the mask marks, and the action's first
USED_SLOTS, ACTION_SLOT = 8, 6
#: the planner's image stream: the scene feature's tokens and their width
IMG_TOKENS = 7


def _linear_shapes(spec: dict) -> List[Tuple[str, tuple]]:
    """(name, weight shape) of every Linear, in the program's module
    order: the model (embedders, blocks, final layer), then the lang, img
    and state adaptors."""
    D, S = spec["hidden_size"], spec["state_token_dim"]
    out = []
    for e in ("t_embedder", "freq_embedder"):
        out += [(f"model.{e}.mlp.0", (D, 256)), (f"model.{e}.mlp.2", (D, D))]
    for i in range(spec["depth"]):
        b = f"model.blocks.{i}"
        out += [(b + ".attn.qkv", (3 * D, D)), (b + ".attn.proj", (D, D)),
                (b + ".cross_attn.q", (D, D)),
                (b + ".cross_attn.kv", (2 * D, D)),
                (b + ".cross_attn.proj", (D, D)),
                (b + ".ffn.fc1", (D, D)), (b + ".ffn.fc2", (D, D))]
    out += [("model.final_layer.ffn_final.fc1", (D, D)),
            ("model.final_layer.ffn_final.fc2", (spec["out_dim"], D)),
            ("lang_adaptor.0", (D, spec["lang_in"])),
            ("lang_adaptor.2", (D, D)),
            ("img_adaptor.0", (D, spec["img_in"])), ("img_adaptor.2", (D, D)),
            ("state_adaptor.0", (D, 2 * S)), ("state_adaptor.2", (D, D)),
            ("state_adaptor.4", (D, D))]
    return out


def _norms(spec: dict) -> List[Tuple[str, int]]:
    D = spec["hidden_size"]
    hd = D // spec["num_heads"]
    out = []
    for i in range(spec["depth"]):
        b = f"model.blocks.{i}"
        out += [(b + ".norm1", D), (b + ".attn.q_norm", hd),
                (b + ".attn.k_norm", hd), (b + ".cross_attn.q_norm", hd),
                (b + ".cross_attn.k_norm", hd), (b + ".norm2", D),
                (b + ".norm3", D)]
    return out + [("model.final_layer.norm_final", D)]


def sincos(positions: int, dim: int) -> Tensor:
    """MAE's 1-D sin-cos table: [sin(p w); cos(p w)], w_i = 1 / 10000^(i /
    (dim / 2)), in float64, then float32."""
    omega = torch.arange(dim // 2, dtype=torch.float64) / (dim / 2.0)
    omega = 1.0 / 10000.0 ** omega
    out = torch.arange(positions, dtype=torch.float64)[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).float()


def draw(spec: dict, nt: int, generator: torch.Generator
         ) -> Dict[str, Tensor]:
    """Every parameter, by its published name."""
    p = {}
    for name, shape in _linear_shapes(spec):
        w = torch.empty(shape)
        if "_embedder." in name:
            torch.nn.init.normal_(w, 0.0, 0.02, generator=generator)
        else:
            torch.nn.init.xavier_uniform_(w, generator=generator)
        p[name + ".weight"] = w
        p[name + ".bias"] = torch.zeros(shape[0])
    for name, dim in _norms(spec):
        p[name + ".weight"] = torch.ones(dim)
    D = spec["hidden_size"]
    p["model.x_pos_embed"] = sincos(nt + 3, D)[None]
    p["model.lang_cond_pos_embed"] = sincos(1, D)[None]
    p["model.img_cond_pos_embed"] = sincos(IMG_TOKENS, D)[None]
    return p


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, w: Tensor, eps: float = 1e-6) -> Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def gelu_tanh(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def softmax(s: Tensor) -> Tensor:
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def forward(p: Dict[str, Tensor], spec: dict, x: Tensor, t: Tensor,
            ego: Tensor, rule: Tensor, scene: Tensor,
            dt=torch.float32) -> Tensor:
    """Epsilon (n, nt, out) of ``x`` (n, nt, 2) at timesteps ``t`` (n,),
    each row with its ego inputs ``ego`` (n, 6), rule ``rule`` (n, 7) and
    scene tokens ``scene`` (n, 7, 32); matmul operands in ``dt``
    (``frozen.cast``), everything else in float32.  Rows in blocks of
    :data:`BLOCK_ROWS`."""
    outs = [_forward(p, spec, *(v[i:i + BLOCK_ROWS]
                                for v in (x, t, ego, rule, scene)), dt)
            for i in range(0, x.shape[0], BLOCK_ROWS)]
    return torch.cat(outs)


def _forward(p, spec, x, t, ego, rule, scene, dt):
    D, H, S = spec["hidden_size"], spec["num_heads"], spec["state_token_dim"]
    hd = D // H
    n, nt = x.shape[:2]

    def c(v):
        return frozen.cast(v, dt)

    def linear(h, name):
        return (c(h) @ c(p[name + ".weight"]).t()
                + c(p[name + ".bias"])).float()

    def norm(h, name):
        return rms_norm(h, p[name + ".weight"])

    def mlp(h, name, n_layers, act=gelu_tanh):
        for i in range(n_layers):
            if i:
                h = act(h)
            h = linear(h, f"{name}.{2 * i}")
        return h

    def embed(name, v):
        half = 128
        f = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=v.device) / half)
        a = v.float()[:, None] * f[None]
        e = torch.cat([torch.cos(a), torch.sin(a)], dim=-1)
        return mlp(e, name + ".mlp", 2, act=lambda h: h * torch.sigmoid(h))

    def heads(h):
        return h.reshape(h.shape[0], h.shape[1], H, hd).transpose(1, 2)

    def attention(q, k, v, name):
        s = (c(q) @ c(k).transpose(-1, -2)).float() / math.sqrt(hd)
        o = (c(softmax(s)) @ c(v)).float()
        return linear(o.transpose(1, 2).reshape(n, -1, D), name + ".proj")

    mask = torch.zeros(S, device=x.device)
    mask[:USED_SLOTS] = 1.0
    u_state = torch.zeros(n, 1, S, device=x.device)
    u_state[:, 0, :ego.shape[-1]] = ego
    u_act = torch.zeros(n, nt, S, device=x.device)
    u_act[..., ACTION_SLOT:ACTION_SLOT + 2] = x
    u = torch.cat([u_state, u_act], dim=1)
    state_action = mlp(torch.cat([u, mask.expand(n, nt + 1, S)], -1),
                       "state_adaptor", 3)
    freq = torch.full((n,), float(spec["freq_hz"]), device=x.device)
    h = torch.cat([embed("model.t_embedder", t)[:, None],
                   embed("model.freq_embedder", freq)[:, None],
                   state_action], dim=1) + p["model.x_pos_embed"]
    lang = mlp(rule[:, None].float(), "lang_adaptor", 2) \
        + p["model.lang_cond_pos_embed"]
    img = mlp(scene.float(), "img_adaptor", 2) + p["model.img_cond_pos_embed"]
    for i in range(spec["depth"]):
        b = f"model.blocks.{i}"
        cond = (lang, img)[i % 2]
        a = norm(h, b + ".norm1")
        qkv = linear(a, b + ".attn.qkv")
        q, k, v = (heads(qkv[..., j * D:(j + 1) * D]) for j in range(3))
        h = h + attention(norm(q, b + ".attn.q_norm"),
                          norm(k, b + ".attn.k_norm"), v, b + ".attn")
        a = norm(h, b + ".norm2")
        q = heads(linear(a, b + ".cross_attn.q"))
        kv = linear(cond, b + ".cross_attn.kv")
        k, v = heads(kv[..., :D]), heads(kv[..., D:])
        h = h + attention(norm(q, b + ".cross_attn.q_norm"),
                          norm(k, b + ".cross_attn.k_norm"), v,
                          b + ".cross_attn")
        a = norm(h, b + ".norm3")
        h = h + linear(gelu_tanh(linear(a, b + ".ffn.fc1")), b + ".ffn.fc2")
    f = "model.final_layer"
    out = linear(gelu_tanh(linear(norm(h, f + ".norm_final"),
                                  f + ".ffn_final.fc1")), f + ".ffn_final.fc2")
    return out[:, -nt:]


# ---------------------------------------------------------------------------
# the frozen planner's eps function
# ---------------------------------------------------------------------------

class Rdt:
    """An RDT on a frozen net: its parameters (moved to the rows' device on
    first use), its widths, where set the precision that overrides the
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
    """Draw ``net``'s encoders and an RDT from ``seed`` (a CPU generator, in
    the program's order) and put the RDT on ``net``; returns it."""
    g = torch.Generator().manual_seed(int(seed))
    ref_unet.draw_encoders(net, g)
    net.rdt = Rdt(draw(spec, net.cfg.nt, g), spec, dt)
    return net


def ego_inputs(batch: Dict[str, Tensor]) -> Tensor:
    """What the frozen ego encoder reads of each scene (bs, 6)."""
    ego = batch["ego_traj"][:, 0]
    xyth = frozen.normalize_xyth(ego[..., :3], ego[..., :3])
    return torch.cat([xyth, ego[..., 3:]], dim=-1)


def make_cm_eps_fn(net, batch: Dict[str, Tensor], highlevel: Tensor,
                   feature: Tensor, cfg, n_randoms: Optional[int] = None):
    """The frozen planner's ``eps_cm(x_cm (bs, nt, 2, R), t)`` for a net
    with an RDT: candidate column r = j * M + m of scene b is row b * 3M +
    m * 3 + j of the feature (the planner's tiling), where the RDT runs,
    and back."""
    r = net.rdt
    M = n_randoms if n_randoms is not None else cfg.n_randoms
    n = feature.shape[0]
    bs = n // (3 * M)
    ego = torch.repeat_interleave(ego_inputs(batch), 3 * M, 0)
    rule = torch.cat([highlevel, batch["stlp_dense"][:, 0]], dim=-1)
    scene = feature.reshape(n, IMG_TOKENS, -1)
    dt = r.dt if r.dt is not None else frozen.compute_dtype(cfg)

    def eps_cm(x_cm: Tensor, t: int) -> Tensor:
        nt = x_cm.shape[1]
        x = x_cm.reshape(bs, nt, 2, 3, M).permute(0, 4, 3, 1, 2)
        x = x.reshape(n, nt, 2)
        ts = torch.full((n,), float(t), device=x.device)
        e = forward(r.on(x.device), r.spec, x, ts, ego, rule, scene, dt)
        e = e.reshape(bs, M, 3, nt, 2).permute(0, 3, 4, 2, 1)
        return e.reshape(bs, nt, 2, 3 * M)

    r.made.append(eps_cm)
    return eps_cm


def install() -> None:
    """Make the frozen planner's ``make_cm_eps_fn`` run :func:`
    make_cm_eps_fn` for a net with an RDT and what ran before for any
    other (idempotent; the frozen files stay as they are)."""
    if getattr(frozen.make_cm_eps_fn, "runs_rdt", False):
        return
    before = frozen.make_cm_eps_fn

    def dispatch(net, *a, **kw):
        if getattr(net, "rdt", None) is not None:
            return make_cm_eps_fn(net, *a, **kw)
        return before(net, *a, **kw)

    dispatch.runs_rdt = True
    frozen.make_cm_eps_fn = dispatch
