"""Policy network (diffusion and VAE heads + RefineNet) as torch
``nn.Module``s — port of ``pstl_tpu/models/net.py``.

Dtypes follow the flax model: fp32 parameters, matmuls in the compute dtype
(``cfg.compute_dtype``, bf16 by default) with the input, weight and bias
cast to it, ReLU in the compute dtype, fp32 out of every MLP.  The matmul
and the bias add are separate ops (two roundings in bf16), as in flax's
``Dense``.  Every head of the JAX package runs: the diffusion head, the VAE
(on the per-scene ``gt_data_training`` "mono" rows, on the multi-candidate
rows with their trajopt controls, or from a prior latent ``sample``), the
BC head and the headless policy, each with the init-hint input under
``use_init_hint``.  :func:`init_flax_like` draws fresh parameters as flax's
``Dense`` does.

``Net(cfg, eps_net=spec)`` puts another eps network in the place of the
diffusion head's eps MLP: the spec builds it (``models/eps_head``), and
it reads the noisy controls, the timestep and the rest of the MLP's input
(scene feature, highlevel, stlp, and the ego inputs of
:func:`ego_inputs`) and returns epsilon itself (no ``+ noise``
residual).  :func:`init_seeded` draws such a net.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from pstl_tpu_torch.config import Config
from pstl_tpu_torch.models import convert, eps_head

Tensor = torch.Tensor


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


def normalize_xyth(state: Tensor, base: Tensor,
                   valid: Optional[Tensor] = None,
                   no_theta: bool = False) -> Tensor:
    """Ego-frame normalization: translate by base (x, y) (gated by
    ``valid``) and rotate into the base heading frame."""
    x, y = state[..., 0], state[..., 1]
    bx, by, bth = base[..., 0], base[..., 1], base[..., 2]
    if valid is not None:
        xt = x - bx * valid
        yt = y - by * valid
    else:
        xt = x - bx
        yt = y - by
    c, s = torch.cos(bth), torch.sin(bth)
    x_rel = xt * c + yt * s
    y_rel = -xt * s + yt * c
    if no_theta:
        return torch.stack([x_rel, y_rel], dim=-1)
    th = state[..., 2]
    th_rel = th - bth * valid if valid is not None else th - bth
    return torch.stack([x_rel, y_rel, th_rel], dim=-1)


def pos_encoding(t: Tensor, channels: int) -> Tensor:
    """Sinusoidal diffusion-timestep embedding.  t: (n, 1) -> (n, channels)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, channels, 2,
                                             dtype=torch.float32,
                                             device=t.device) / channels))
    ang = t.float() * inv_freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense(x: Tensor, layer: nn.Linear, dt: torch.dtype) -> Tensor:
    """flax ``Dense(dtype=dt, param_dtype=float32)``: cast, matmul, add."""
    return x.to(dt) @ layer.weight.to(dt).t() + layer.bias.to(dt)


class MLP(nn.Module):
    """Dense-ReLU stack, ReLU between layers only.  ``layers[i]`` holds
    flax's ``Dense_i``."""

    def __init__(self, d_in: int, features: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [d_in] + list(features)
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1])
                                    for i in range(len(features)))
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        x = x.to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = dense(x, layer, self.dtype)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x.float()


def ego_inputs(batch: Dict[str, Tensor]) -> Tensor:
    """What the ego encoder reads of each scene (bs, 6): the first ego
    state in its own frame, then its remaining fields."""
    ego = batch["ego_traj"][:, 0]
    ego_xyth = normalize_xyth(ego[..., :3], ego[..., :3])
    return torch.cat([ego_xyth, ego[..., 3:]], dim=-1)


class Net(nn.Module):
    """Conditional diffusion policy with the RefineNet rectification head;
    with ``eps_net`` (a spec of ``models/eps_head``) the diffusion head is
    the network it builds instead of the eps MLP."""
    FEAT_DIM = 32
    STLP_DIM = 6
    TIME_DIM = 32
    LANE_DIM = 3

    def __init__(self, cfg: Config,
                 eps_net=None):
        super().__init__()
        self.cfg = cfg
        h = tuple(cfg.hiddens)
        dt = compute_dtype(cfg)
        F = self.FEAT_DIM
        self.ego_encoder = MLP(6, h + (F,), dt)
        self.neighbor_encoder = MLP(7, h + (F,), dt)
        self.lane_encoder = MLP(cfg.n_segs * self.LANE_DIM, h + (F,), dt)
        feat = 7 * F
        if eps_net is None:
            self.policy_net = MLP(feat + cfg.latent_dim,
                                  h + (cfg.nt * 2,), dt)
            self.eps_net = None
        else:
            if not cfg.diffusion:
                raise ValueError("eps_net is a diffusion head: it needs "
                                 "cfg.diffusion")
            self.eps_net = eps_net.build(cfg, eps_head.Planner(
                7, F, 1 + self.STLP_DIM))
        if cfg.vae:
            self.traj_encoder = MLP(cfg.nt * 2, h + (cfg.vae_dim * 2,), dt)
        if cfg.rect_head:
            rect_in = feat + 1 + self.STLP_DIM + cfg.nt * 2
            if cfg.diverse_loss:
                self.merge_net = MLP(cfg.nt * 2, (32, 32, cfg.nt * 2), dt)
                if cfg.diverse_fuse_type == "cat":
                    rect_in += cfg.nt * 2
            self.rect_net = MLP(rect_in, tuple(cfg.rect_hiddens)
                                + (cfg.nt * 2,), dt)

    # ------------------------------------------------------------------
    def encode(self, batch: Dict[str, Tensor]) -> Tensor:
        """Scene feature (bs, 7*32)."""
        cfg = self.cfg
        bs = batch["ego_traj"].shape[0]
        ego_un = batch["ego_traj"][:, 0][:, None, :]
        neis = batch["neighbors"]                          # (bs, K, 7)
        neis_xyth = normalize_xyth(neis[..., 1:4], ego_un[..., :3],
                                   neis[..., 0])
        neis_in = torch.cat([neis[..., 0:1], neis_xyth, neis[..., 4:7]], -1)
        lanes = torch.stack(
            [normalize_xyth(batch[f"{k}lane_wpts"], ego_un[..., :3],
                            batch[f"{k}_id"])
             for k in ("curr", "left", "right")], dim=1)   # (bs,3,S,3)
        lanes_in = torch.cat(
            [lanes[..., 0:1, :], lanes[..., 1:, :] - lanes[..., :-1, :]],
            dim=-2).reshape(bs, 3, cfg.n_segs * self.LANE_DIM)
        ego_feat = self.ego_encoder(ego_inputs(batch))
        nei_feat = self.neighbor_encoder(neis_in)          # (bs, K, 32)
        nei_feat = torch.cat([torch.amin(nei_feat, 1),
                              torch.mean(nei_feat, 1),
                              torch.amax(nei_feat, 1)], dim=-1)
        lane_feat = self.lane_encoder(lanes_in).reshape(bs, -1)
        return torch.cat([ego_feat, nei_feat, lane_feat], dim=-1)

    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, Tensor], ext: Dict[str, Tensor],
                prev_feature: Optional[Tensor] = None,
                n_randoms: Optional[int] = None,
                get_feature: bool = False,
                sample: Optional[Tensor] = None):
        """Policy forward (``pstl_tpu.models.net.Net.__call__``).

        Multi-candidate rows (the planner, the dense step): the scene
        feature is tiled to bs * n_randoms * 3 rows and ``stlp_dense``
        supplies the pSTL parameters; mono rows (``gt_data_training``): the
        per-scene feature, ext["highlevel"] (bs, 1) and ext["gt_stlp"]
        (bs, 6) are tiled to n = bs * n_randoms rows.  ext per head:
        diffusion timestep (n, 1), highlevel, noise (n, nt*2); VAE
        highlevel and its latent noise (n, vae_dim) with
        ext["trajopt_controls"] (n, nt, 2) (multi) or ext["gt_controls"]
        (bs, nt, 2) (mono) to encode, or the latent itself as ``sample``;
        BC highlevel; the headless policy reads batch["gt_high_level"].
        Under ``use_init_hint`` batch["params_init"] (a control seed a row)
        joins the input.  Diffusion returns the epsilon prediction
        (n, nt, 2) (and the feature with ``get_feature``); the others
        tanh-bounded controls, the VAE with (mean, logstd, std) of its
        latent ((None,) * 3 from ``sample``).
        """
        cfg = self.cfg
        multi = cfg.multi_check
        if n_randoms is None:
            n_randoms = cfg.n_randoms
        if prev_feature is not None:
            feature = prev_feature
        else:
            feature = self.encode(batch)
            if multi:
                feature = torch.repeat_interleave(feature, n_randoms * 3, 0)
        stlp_feat = batch["stlp_dense"][:, 0] if multi else ext["gt_stlp"]
        tile = lambda v: torch.repeat_interleave(v, n_randoms, 0)
        latent_stats = (None, None, None)
        if self.eps_net is not None:
            cond = [feature, ext["highlevel"], stlp_feat]
            if not multi:
                cond = [tile(v) for v in cond]
            eps = self.eps_net.rows(self, batch, *cond, ext["noise"],
                                    ext["timestep"])
            return (eps, feature) if get_feature else eps
        if cfg.diffusion:
            time_feat = pos_encoding(ext["timestep"], self.TIME_DIM)
            if multi:
                pin = torch.cat([feature, ext["noise"], time_feat,
                                 ext["highlevel"], stlp_feat], -1)
            else:
                pin = torch.cat([tile(feature), ext["noise"], time_feat,
                                 tile(ext["highlevel"]), tile(stlp_feat)],
                                -1)
        elif cfg.bc:
            pin = torch.cat([feature, ext["highlevel"], stlp_feat], -1)
        elif cfg.vae:
            if sample is not None:
                latent = sample
                feat, hl, stlp = feature, ext["highlevel"], stlp_feat
            else:
                if multi:
                    code = self.traj_encoder(
                        ext["trajopt_controls"].reshape(-1, cfg.nt * 2))
                    feat, hl, stlp = feature, ext["highlevel"], stlp_feat
                else:
                    code = tile(self.traj_encoder(
                        ext["gt_controls"].reshape(-1, cfg.nt * 2)))
                    feat, hl, stlp = (tile(feature), tile(ext["highlevel"]),
                                      tile(stlp_feat))
                mean = code[..., :cfg.vae_dim]
                logstd = code[..., cfg.vae_dim:]
                std = torch.exp(logstd)
                latent = ext["noise"] * std + mean
                latent_stats = (mean, logstd, std)
            pin = torch.cat([feat, latent, hl, stlp], -1)
        else:
            pin = torch.cat([feature, batch["gt_high_level"], stlp_feat], -1)
        if cfg.use_init_hint:
            hint = batch["params_init"].reshape(pin.shape[:-1]
                                                + (cfg.nt * 2,))
            pin = torch.cat([pin, hint], -1)
        raw = self.policy_net(pin)
        if cfg.diffusion:
            controls = (raw + ext["noise"]).reshape(-1, cfg.nt, 2)
        else:
            raw = raw.reshape(-1, cfg.nt, 2)
            controls = torch.stack(
                [torch.tanh(raw[..., 0]) * cfg.mul_w_max,
                 torch.tanh(raw[..., 1]) * cfg.mul_a_max], dim=-1)
        if get_feature:
            return controls, feature
        if cfg.vae:
            return controls, latent_stats
        return controls

    # ------------------------------------------------------------------
    def rect(self, feature: Tensor, highlevel: Tensor, stlp: Tensor,
             init_controls: Tensor, scores: Tensor) -> Tensor:
        """RefineNet rectification of violating candidates (scores < 0),
        with the merge-net shard max (``diverse_loss``) and the tanh
        interval reparameterization (``interval``)."""
        cfg = self.cfg
        n = feature.shape[0]
        D = cfg.nt * 2
        if cfg.diverse_loss and not cfg.no_arch:
            fused = self.merge_net(init_controls.reshape(-1, D))
            M, NS = cfg.n_randoms, cfg.n_shards
            if M % NS or n % (3 * M):
                raise ValueError(
                    f"rect diversity fusion needs n_randoms ({M}) divisible "
                    f"by n_shards ({NS}) and rows ({n}) divisible by 3*M")
            bs = n // (3 * M)
            fused = fused.reshape(bs, M, 3, D).transpose(1, 2)
            fused = fused.reshape(bs, 3, NS, M // NS, D)
            fused = torch.amax(fused, dim=3, keepdim=True).expand(
                bs, 3, NS, M // NS, D).reshape(bs, 3, M, D)
            fused = fused.transpose(1, 2).reshape(n, cfg.nt, 2)
            if cfg.diverse_fuse_type == "add":
                pin = torch.cat([feature, highlevel, stlp,
                                 (init_controls + fused).reshape(n, D)], -1)
            elif cfg.diverse_fuse_type == "cat":
                pin = torch.cat([feature, highlevel, stlp,
                                 init_controls.reshape(n, D),
                                 fused.reshape(n, D)], -1)
            else:
                raise NotImplementedError(cfg.diverse_fuse_type)
        else:
            pin = torch.cat([feature, highlevel, stlp,
                             init_controls.reshape(n, D)], -1)
        raw = self.rect_net(pin).reshape(n, cfg.nt, 2)
        if cfg.interval:
            init_w, init_a = init_controls[..., 0], init_controls[..., 1]
            t = torch.tanh(raw)
            w_mask = (t[..., 0] >= 0).to(t.dtype)
            a_mask = (t[..., 1] >= 0).to(t.dtype)
            w0 = t[..., 0] * (init_w + cfg.mul_w_max)
            w1 = t[..., 0] * (cfg.mul_w_max - init_w)
            a0 = t[..., 1] * (init_a + cfg.mul_a_max)
            a1 = t[..., 1] * (cfg.mul_a_max - init_a)
            raw = torch.stack([w0 * (1 - w_mask) + w1 * w_mask,
                               a0 * (1 - a_mask) + a1 * a_mask], dim=-1)
        violated = (scores < 0).to(raw.dtype)[:, None, None]
        out = init_controls + raw * violated
        if cfg.clip_rect:
            out = torch.stack(
                [torch.clamp(out[..., 0], -cfg.mul_w_max, cfg.mul_w_max),
                 torch.clamp(out[..., 1], -cfg.mul_a_max, cfg.mul_a_max)],
                dim=-1)
        return out


# ----------------------------------------------------------------------
#: flax's lecun_normal: a normal truncated to [-2, 2] has this standard
#: deviation, and the draw is divided by it
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_flax_like(net: nn.Module, generator: torch.Generator) -> None:
    """Draw every ``Linear`` as flax's default ``Dense`` initializes it:
    lecun-normal weights (a normal truncated to two standard deviations,
    scaled to variance 1/fan_in) and zero biases, from ``generator``, in
    module order.  (PyTorch's default ``Linear`` init is a different
    distribution.)"""
    for m in net.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            m.weight.mul_(std)
            nn.init.zeros_(m.bias)


@torch.no_grad()
def init_seeded(net: Net, generator: torch.Generator) -> None:
    """Fresh parameters for ``net`` from ``generator``: its MLPs as flax's
    ``Dense`` (:func:`init_flax_like`), in module order, then an eps head
    by its own rule (``EpsHead.init_seeded``: the published code's)."""
    for name, child in net.named_children():
        if name != "eps_net":
            init_flax_like(child, generator)
    if net.eps_net is not None:
        net.eps_net.init_seeded(generator)


class EpsWeights:
    """The weight-only pieces of the candidate-minor eps MLP
    (:func:`make_cm_eps_fn`), in the compute dtype: layer 1 split by input
    block (feature ``Wf``, highlevel ``Wh``, stlp ``Ws``, init hint ``Wi``,
    noise ``WnT`` transposed, timestep ``Wt``) and its bias ``b1``, the
    hidden layers ``midT`` and the output layer (``WoT``, ``bo``)
    transposed so every product is W (rows, k) @ h (k, R), and the
    superstep kernel's channel-split copies (``superstep``)."""

    def __init__(self, net: Net, cfg: Config):
        layers = net.policy_net.layers
        kern = [l.weight.t() for l in layers]             # flax (in, out)
        bias = [l.bias for l in layers]
        dt = compute_dtype(cfg)
        F, D, TD = 7 * Net.FEAT_DIM, cfg.nt * 2, Net.TIME_DIM
        W1 = kern[0]
        o = F + D + TD
        self.dt = dt
        self.Wf = W1[:F].to(dt)
        self.Wh = W1[o:o + 1].to(dt)
        self.Ws = W1[o + 1:o + 1 + Net.STLP_DIM].to(dt)
        self.Wi = W1[o + 1 + Net.STLP_DIM:].to(dt)
        self.b1 = bias[0].to(dt)
        self.WnT = W1[F:F + D].to(dt).t().contiguous()    # (h1, D)
        self.Wt = W1[F + D:o].to(dt)
        self.midT = [(kern[i].to(dt).t().contiguous(),
                      bias[i].to(dt)[None, :, None])
                     for i in range(1, len(kern) - 1)]
        self.WoT = kern[-1].to(dt).t().contiguous()
        self.bo = bias[-1].to(dt)[None, :, None]
        # the superstep kernel's (ops/superstep_kernel.py), in the JAX
        # package's names and layouts: split by control channel (row d =
        # t*2 + c of the noise block and of the output)
        Wo = kern[-1].to(dt)
        bo_all = bias[-1].to(dt)
        self.superstep = dict(
            Wt=self.Wt,                                   # (TIME_DIM, h1)
            WnwT=self.WnT[:, 0::2].contiguous(),          # (h1, nt)
            WnaT=self.WnT[:, 1::2].contiguous(),
            mid=[(WT, b.reshape(-1, 1)) for WT, b in self.midT],
            WowT=Wo[:, 0::2].t().contiguous(),            # (nt, h_last)
            WoaT=Wo[:, 1::2].t().contiguous(),
            bow=bo_all[0::2].reshape(-1, 1),              # (nt, 1)
            boa=bo_all[1::2].reshape(-1, 1))


def eps_weights(net: Net, cfg: Config):
    """The net's :class:`EpsWeights` (an eps head's ``weights``), made
    once while its policy MLP's parameters stay (``convert.cast_once``)."""
    if net.eps_net is not None:
        return net.eps_net.weights(compute_dtype(cfg))
    return convert.cast_once(net.policy_net, (compute_dtype(cfg), cfg.nt),
                             lambda: EpsWeights(net, cfg))


def cm_eps(base_cm: Tensor, w: EpsWeights, cfg: Config):
    """``eps_cm(x_cm (bs, nt, 2, R), t) -> eps`` on the per-plan layer-1
    contribution ``base_cm`` (bs, h1, R) and the weight pieces ``w``, with
    what the chain's graph reads of it (``diffusion``; ``inputs``
    {"base_cm"}) and ``operands``, the superstep kernel's pieces."""
    bs, _, R = base_cm.shape
    D = cfg.nt * 2
    dt = w.dt

    def eps_cm(x_cm: Tensor, t: int) -> Tensor:
        te = pos_encoding(torch.full((1, 1), float(t), device=x_cm.device),
                          Net.TIME_DIM)
        h = (base_cm + (te.to(dt) @ w.Wt)[0][None, :, None]
             + w.WnT @ x_cm.reshape(bs, D, R).to(dt))
        h = torch.relu(h)
        for WT, b in w.midT:
            h = torch.relu(WT @ h + b)
        raw = w.WoT @ h + w.bo
        return raw.float().reshape(bs, cfg.nt, 2, R) + x_cm

    eps_cm.weights = w
    eps_cm.inputs = {"base_cm": base_cm}
    eps_cm.on_base = lambda d: cm_eps(d["base_cm"], w, cfg)
    eps_cm.operands = dict(base_cm=base_cm,               # (bs, h1, R)
                           **w.superstep, dt=dt, bs=bs, R=R, nt=cfg.nt)
    return eps_cm


def make_cm_eps_fn(net: Net, batch: Dict[str, Tensor], highlevel: Tensor,
                   feature: Tensor, cfg: Config,
                   n_randoms: Optional[int] = None):
    """Candidate-minor epsilon predictor for the DDPM reverse loop.

    Layer 1 of the policy MLP is linear, so it splits by input block: the
    feature / highlevel / stlp (and init-hint) contribution ``base`` is
    computed once per plan and laid out candidate-minor (bs, h1, R); the
    timestep embedding gives one (h1,) vector per denoise step; only the
    noise block depends on x.  The weight pieces are the net's
    (:func:`eps_weights`), made once.  Returns ``eps_cm(x_cm (bs, nt, 2,
    R), t) -> eps`` with r = j*M + m (``specs.CandMinorGuidanceLoss``'s
    layout; :func:`cm_eps`); its ``operands`` dict holds the pieces for the
    superstep kernel.  An eps head gives its own (``EpsHead.cm_eps``).
    """
    M = n_randoms if n_randoms is not None else cfg.n_randoms
    bs = feature.shape[0] // (M * 3)
    R = M * 3
    stlp_feat = batch["stlp_dense"][:, 0]
    if net.eps_net is not None:
        net.eps_net.check_route(cfg)
        return net.eps_net.cm_eps(net, batch, highlevel, feature, stlp_feat,
                                  cfg, M)
    w = eps_weights(net, cfg)
    dt = w.dt
    base = (feature.to(dt) @ w.Wf + highlevel.to(dt) @ w.Wh
            + stlp_feat.to(dt) @ w.Ws + w.b1)
    if cfg.use_init_hint:
        hint = batch["params_init"].reshape(-1, cfg.nt * 2)
        base = base + hint.to(dt) @ w.Wi
    h1 = base.shape[-1]
    base_cm = base.reshape(bs, M, 3, h1).permute(0, 3, 2, 1).reshape(
        bs, h1, R)
    return cm_eps(base_cm, w, cfg)

