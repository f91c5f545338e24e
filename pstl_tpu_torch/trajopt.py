"""Trajectory-optimization data augmentation (port of
``pstl_tpu/trajopt.py``): Adam directly on the raw control tensors of 64
seeds x 3 maneuvers a scene, loss = a weighted hinge of the STL robustness
under K flex pSTL draws + the control-bound penalty.  It writes the
sidecars the dense training step reads: ``params`` (the optimized
controls), ``pre_stlp`` (the pSTL draw each row is conditioned on) and
``tj_scores_prior`` (its score).

The JAX package runs the whole optimization as one jitted ``lax.scan``;
here it is a Python loop of ``iters`` steps, each a ``torch.autograd.grad``
of :func:`trajopt_loss` and an update of ``optim.Adam`` (``optax.adam``
written out, on ``cosine_decay_schedule(3 * trajopt_lr, iters,
alpha=0.02)``).  The learning rates, Adam's bias corrections and the
annealed temperatures are float32 tables computed once on the host
(:func:`schedules`).  The robustness is the ``ClauseBank``'s
(``specs.build_scorer``); the formula tree stays refused.

Every random draw of :func:`augment_dataset` goes through one seam: a
batch's flex uniforms (``specs.flex_uniforms``: the densify draw, the K-1
extra draws and the fresh-draw probe) come from ``draws`` when it is
given, else from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from pstl_tpu_torch import optim, specs
from pstl_tpu_torch.config import Config
from pstl_tpu_torch.device import resolve_device
from pstl_tpu_torch.ops import dynamics as dyn
from pstl_tpu_torch.train import to_device

Tensor = torch.Tensor


def trajopt_loss(params: Tensor, states_flat: Tensor,
                 signal_base: Dict[str, Tensor], highlevel: Tensor,
                 formulas, cfg: Config, tau: Optional[float] = None,
                 stlp_draws: Optional[Tensor] = None):
    """params: (n, nt, 2) flat dense controls; returns (loss, aux).

    ``stlp_draws`` (K, n, 1, 6): a weighted hinge over K flex draws instead
    of the single draw in ``signal_base``: half the weight on draw 0 (the
    canonical draw whose stlp and score are persisted), half spread over the
    others.  The geometry signals do not depend on the draw and are prepared
    once (``specs.prep_signals``); only the clauses repeat per draw.  The
    valid-mask mean is clipped at 1e-3 (not ``mask_mean``'s 1e-2)."""
    valid = signal_base["dense_valids"].reshape(-1)
    trajs = dyn.rollout(states_flat, params, cfg.dt)
    sig = dict(signal_base)
    sig["ego_traj"] = trajs[:, :-1]
    if stlp_draws is None:
        _, scores, _ = specs.compute_scores(sig, formulas, highlevel, valid,
                                            cfg, tau=tau)
        hinge = torch.relu(cfg.stl_trajopt_thres - scores)
    else:
        sig = specs.prep_signals(sig, cfg)
        K = stlp_draws.shape[0]
        w = [1.0] if K == 1 else [0.5] + [0.5 / (K - 1)] * (K - 1)
        hinge = 0.0
        scores = None
        for k in range(K):
            sk = dict(sig)
            sk["stlp"] = stlp_draws[k]
            _, s_k, _ = specs.compute_scores(sk, formulas, highlevel, valid,
                                             cfg, tau=tau)
            hinge = hinge + w[k] * torch.relu(cfg.stl_trajopt_thres - s_k)
            if k == 0:
                scores = s_k
    dense_loss = (torch.mean(hinge * valid)
                  / torch.clamp(torch.mean(valid), min=1e-3))
    reg = (torch.mean(torch.relu(params[..., 0] ** 2 - cfg.mul_w_max ** 2))
           + torch.mean(torch.relu(params[..., 1] ** 2 - cfg.mul_a_max ** 2))
           ) * cfg.reg_loss
    loss = dense_loss + reg
    if cfg.trajopt_nonneg_speed:
        # keep the oracle from braking past v = 0 (squared hinge)
        loss = loss + cfg.trajopt_nonneg_speed * torch.mean(
            torch.square(torch.relu(-trajs[..., 3])))
    return loss, {"dense_loss": dense_loss, "reg_loss": reg,
                  "scores": scores, "trajs": trajs}


class Schedules(NamedTuple):
    """Per-iteration float32 scalars of :func:`optimize` (host numpy)."""
    step: np.ndarray     # optax's step size at count i: -lr(i)
    bc1: np.ndarray      # 1 - b1 ** (i + 1)
    bc2: np.ndarray      # 1 - b2 ** (i + 1)
    tau: np.ndarray      # the annealed temperature of iteration i


def schedules(cfg: Config, iters: int) -> Schedules:
    """The learning rate (``cosine_decay_schedule(3 * trajopt_lr, iters,
    alpha=0.02)`` read at counts 0..iters-1), Adam's bias corrections and
    the temperature annealed geometrically from min(10, tau_final) to
    tau_final = ``smoothing_factor``, each in float32 in the JAX package's
    order of operations.  Its ``cos`` and ``pow`` are not XLA's: entries
    may differ from JAX's by a few ulp (``tests/test_torch_trajopt.py``)."""
    f32 = torch.float32
    count = torch.arange(iters, dtype=f32)
    steps = float(iters)
    cosine = 0.5 * (1 + torch.cos(torch.tensor(np.pi, dtype=f32)
                                  * torch.clamp(count, max=steps) / steps))
    lr = (cfg.trajopt_lr * 3.0) * ((1 - 0.02) * cosine + 0.02)
    bc1, bc2 = optim.bias_corrections(iters)
    tau_final = cfg.smoothing_factor
    tau_start = min(10.0, tau_final)
    frac = count / max(iters - 1, 1)
    tau = tau_start * torch.tensor(tau_final / tau_start, dtype=f32) ** frac
    return Schedules(step=(-lr).numpy(), bc1=bc1, bc2=bc2, tau=tau.numpy())


def optimize(params0: Tensor, states: Tensor,
             signal_base: Dict[str, Tensor], highlevel: Tensor, formulas,
             cfg: Config, iters: Optional[int] = None,
             stlp_draws: Optional[Tensor] = None,
             on_iter: Optional[Callable[[int], None]] = None):
    """Adam on the flat controls for ``iters`` steps (default
    ``cfg.traj_opt_iters``).

    params0: (bs, M, 3, nt, 2) initial control seeds; states: (bs, 4) scene
    initial states; signal_base: the densified signal input
    (``specs.dense_signal_input``); stlp_draws: optional (K, n, 1, 6) flex
    draws (see :func:`trajopt_loss`).  ``on_iter(i)`` runs after step i (a
    timing hook; the loop does not synchronise the device).  Returns
    (params (bs, M, 3, nt, 2), scores (bs, M, 3) at the default temperature
    on the canonical draw, aux)."""
    if iters is None:
        iters = cfg.traj_opt_iters
    bs, M = params0.shape[0], params0.shape[1]
    n = bs * M * 3
    p = params0.reshape(n, cfg.nt, 2).detach()
    states_flat = states[:, None, None].expand(bs, M, 3, 4).reshape(n, 4)
    sch = schedules(cfg, iters)
    adam = optim.Adam(p, -sch.step, iters)
    for i in range(iters):
        with torch.enable_grad():
            x = p.detach().requires_grad_(True)
            loss, _ = trajopt_loss(x, states_flat, signal_base, highlevel,
                                   formulas, cfg, tau=float(sch.tau[i]),
                                   stlp_draws=stlp_draws)
            g, = torch.autograd.grad(loss, x)
        with torch.no_grad():
            p = adam.update(p, g, i)
        if on_iter is not None:
            on_iter(i)
    with torch.no_grad():
        loss, aux = trajopt_loss(p, states_flat, signal_base, highlevel,
                                 formulas, cfg)
    return (p.reshape(bs, M, 3, cfg.nt, 2), aux["scores"].reshape(bs, M, 3),
            {"loss": loss, "dense_loss": aux["dense_loss"],
             "reg_loss": aux["reg_loss"]})


def batch_draws(bs: int, K: int, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, object]:
    """One batch's flex uniforms, in the order the JAX package splits its
    keys: the densify draw, the K-1 extra draws, the fresh-draw probe; each
    (3, 6, bs, 1) (``specs.flex_uniforms``)."""
    return {"densify": specs.flex_uniforms(bs, generator, device),
            "extra": [specs.flex_uniforms(bs, generator, device)
                      for _ in range(K - 1)],
            "fresh": specs.flex_uniforms(bs, generator, device)}


def augment_dataset(ds, cfg: Config, formulas, batch_size: int = 64,
                    iters: Optional[int] = None, seed: int = 0,
                    verbose: bool = True, epochs: int = 1,
                    draws: Optional[Iterable[Dict[str, object]]] = None,
                    device=None, log: Callable = print,
                    on_iter: Optional[Callable[[int], None]] = None):
    """Offline augmentation pass over a ``SceneDataset``: attaches the
    ``params`` (optimized), ``pre_stlp`` and ``tj_scores_prior`` columns
    and sets ``ds.trajopt_stats`` ({"acc_seen", "acc_fresh"}: the
    valid-masked satisfaction of the persisted and of a fresh flex draw,
    averaged over the last epoch's batches).

    Batches of ``batch_size`` samples; the last is padded by repeating its
    first indices, as the JAX package pads it (which doubles a tail shorter
    than half a batch rather than filling it).  Per batch: the pSTL
    calibration and ``densify_batch`` under ``flex``, the hoisted signals
    (``dense_signal_input`` with the non-flex ``cfg``), K =
    ``trajopt_robust_draws`` flex draws, :func:`optimize`, the fresh-draw
    probe and, for K > 1, the draw each row best satisfies persisted
    (earliest on ties).  With ``epochs`` > 1 each epoch warm-starts from the
    previous one's optimum.

    ``draws``: one dict a batch, in the loop's order (epoch by epoch), as
    :func:`batch_draws` makes it; by default drawn from a generator on the
    device seeded with ``seed``.  Runs on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    ds.ensure_random_params(seed)
    n = len(ds)
    M = cfg.n_randoms
    cfg_flex = cfg.with_(flex=True)
    params_out = np.zeros_like(ds.data["params"])
    scores_out = np.zeros((n, M, 3), np.float32)
    stlp_out = np.zeros((n, M, 3, 1, 6), np.float32)
    K = max(int(cfg.trajopt_robust_draws), 1)
    gen = None
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    else:
        draws = iter(draws)

    @torch.no_grad()
    def score_under(params, states, sb, hl, stlp_dense):
        """Scores of optimized controls under another dense stlp."""
        rows = params.shape[0] * params.shape[1] * 3
        sb = dict(sb, stlp=stlp_dense)
        states_flat = states[:, None, None].expand(
            states.shape[0], params.shape[1], 3, 4).reshape(rows, 4)
        _, aux = trajopt_loss(params.reshape(rows, cfg.nt, 2), states_flat,
                              sb, hl, formulas, cfg_flex)
        return aux["scores"]

    def host(x):
        return x.detach().cpu().numpy()

    n_epochs = max(epochs, 1)
    accs_seen, accs_fresh = [], []
    for ep in range(n_epochs):
        for i0 in range(0, n, batch_size):
            idx = np.arange(i0, min(i0 + batch_size, n))
            if len(idx) < batch_size:
                idx = np.concatenate([idx, idx[:batch_size - len(idx)]])
            bsb = len(idx)
            batch = to_device(ds.gather(idx), dev)
            batch["neighbor_trajs_aug"] = batch["neighbors_traj"]
            if ep > 0:
                batch["params"] = torch.as_tensor(params_out[idx], device=dev)
            d = (next(draws) if gen is None
                 else batch_draws(bsb, K, gen, dev))
            gt = batch["ego_traj"][..., :4]
            with torch.no_grad():
                stlp = specs.calibrate_stlp(batch, gt, cfg_flex)
                dense = specs.densify_batch(batch, stlp, cfg_flex,
                                            flex=d["densify"])
                signal_base = specs.dense_signal_input(dense, cfg=cfg)
                stlp_draws: List[Tensor] = [dense["stlp_dense"]] + [
                    specs.get_dense_stlp(batch["gt_high_level"], stlp,
                                         cfg_flex, flex=f)
                    for f in d["extra"]]
            states = gt[:, 0]
            hl = dense["highlevel_dense"]
            params, scores, aux = optimize(
                batch["params"], states, signal_base, hl, formulas, cfg_flex,
                iters=iters, stlp_draws=torch.stack(stlp_draws),
                on_iter=on_iter)
            with torch.no_grad():
                fresh = specs.get_dense_stlp(batch["gt_high_level"], stlp,
                                             cfg_flex, flex=d["fresh"])
            s_fresh = host(score_under(params, states, signal_base, hl,
                                       fresh))
            valid = host(dense["valids_dense"]).reshape(-1)
            acc_fresh = float((np.asarray(s_fresh > 0) * valid).sum()
                              / max(valid.sum(), 1.0))
            if K > 1:
                s_all = [host(scores).reshape(-1)] + [
                    host(score_under(params, states, signal_base, hl,
                                     stlp_draws[kk])) for kk in range(1, K)]
                S = np.stack([s.reshape(bsb, M, 3) for s in s_all])
                kstar = np.argmax(S, axis=0)
                scores_np = np.max(S, axis=0)
                D = np.stack([host(s).reshape(bsb, M, 3, 6)
                              for s in stlp_draws])
                stlp_np = np.take_along_axis(
                    D, kstar[None, ..., None], axis=0)[0][..., None, :]
            else:
                scores_np = host(scores)
                stlp_np = host(dense["stlp_dense"]).reshape(bsb, M, 3, 1, 6)
            real = np.arange(i0, min(i0 + batch_size, n)) - i0
            params_out[i0:i0 + len(real)] = host(params)[real]
            scores_out[i0:i0 + len(real)] = scores_np[real]
            stlp_out[i0:i0 + len(real)] = stlp_np[real]
            acc = float(((scores_np.reshape(-1) > 0) * valid).sum()
                        / max(valid.sum(), 1.0))
            if ep == n_epochs - 1:
                accs_seen.append(acc)
                accs_fresh.append(acc_fresh)
            if verbose:
                log(f"trajopt [{ep}|{i0:5d}/{n}] "
                    f"loss={float(aux['loss']):.4f} acc={acc:.3f} "
                    f"fresh={acc_fresh:.3f}")
    ds.attach("params", params_out)
    ds.attach("tj_scores_prior", scores_out)
    ds.attach("pre_stlp", stlp_out)
    stats = {"acc_seen": float(np.mean(accs_seen)),
             "acc_fresh": float(np.mean(accs_fresh))}
    if verbose:
        log(f"trajopt oracle: seen={stats['acc_seen']:.3f} "
            f"fresh-draw={stats['acc_fresh']:.3f} (K={K} draws)")
    ds.trajopt_stats = stats
    return ds
