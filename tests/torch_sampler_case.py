"""Shared case of the sampler parity tests
(``tests/test_torch_fast_samplers.py``, ``test_torch_rowmajor_guidance.py``):
both packages' configs, dense batches and nets on one seeded guidance
problem (``torch_parity.guidance_case``: 2 scenes, M = 4, K = 3, width-32
nets, fp32, 10 denoise steps by default), and each package's sampler run
through its ``sample`` dispatch with the guidance context the planner
builds (``score_rows``, the validity mask, the dense initial states and,
where enabled, the candidate-minor fused loss).

The port's sampler takes the JAX key chain's draws
(``torch_parity.jax_cm_noise`` with ``diffusion.n_draws`` draws of
``diffusion.draw_layout``'s shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pstl_tpu import diffusion as jdiff
from pstl_tpu import specs as jspecs
from pstl_tpu.config import Config as JConfig
from pstl_tpu.models import Net as JNet
from pstl_tpu.models import net as jnet
from pstl_tpu_torch import diffusion as tdiff
from pstl_tpu_torch import specs as tspecs
from pstl_tpu_torch.config import Config as TConfig
from pstl_tpu_torch.models import convert
from pstl_tpu_torch.models import net as tnet

from torch_parity import F32, guidance_case, jax_cm_noise, to_t

#: the shared flags of the case (the planner's dense rows, guided)
FLAGS = dict(diffusion=True, rect_head=True, diverse_loss=True,
             n_neighbors=3, hiddens=(32, 32), rect_hiddens=(32, 32),
             compute_dtype="float32", guidance=True, guidance_niters=3,
             clearance_coarse_pair=True, guidance_reuse_selection=True,
             flex=True)


class Case:
    """Both packages' side of one sampler problem; ``jax_kw`` / ``torch_kw``
    override one package's config only (the guidance route)."""

    def __init__(self, bs=2, M=4, steps=10, seed=0, jax_kw=None,
                 torch_kw=None, **kw):
        flags = dict(FLAGS, n_randoms=M, diffusion_steps=steps)
        flags.update(kw)
        self.cfg_j = JConfig(**flags).with_(**(jax_kw or {})).finalize()
        self.cfg_t = TConfig(**flags).with_(**(torch_kw or {})).finalize()
        batch, gt, stlp, states, _ = guidance_case(seed, bs, M, 20, 3, 15)
        batch["ego_traj"] = np.concatenate(
            [np.repeat(states[:, None], 20, 1),
             np.full((bs, 20, 2), 2.0, F32)], -1).astype(F32)
        batch["neighbors"] = batch["neighbor_trajs_aug"][:, :, 0]
        self.bs, self.M, self.n = bs, M, bs * M * 3
        self.states = states
        self.dj = jspecs.densify_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(gt),
            self.cfg_j, stlp_dense=jnp.asarray(stlp))
        self.dt = tspecs.densify_batch(to_t(batch), torch.as_tensor(gt),
                                       self.cfg_t, torch.as_tensor(stlp))
        self.net_j = JNet(self.cfg_j)
        ext0 = {"timestep": jnp.ones((self.n, 1)),
                "highlevel": self.dj["highlevel_dense"],
                "noise": jnp.zeros((self.n, 40))}
        self.params = self.net_j.init(jax.random.PRNGKey(seed + 1), self.dj,
                                      ext0, method=JNet.init_all)
        _, self.feat_j = self.net_j.apply(self.params, self.dj, ext0,
                                          get_feature=True)
        self.net_t = tnet.Net(self.cfg_t)
        self.net_t.load_state_dict(convert.from_flax(
            jax.tree_util.tree_map(np.asarray, self.params)))
        self.net_t.eval()
        with torch.no_grad():
            self.feat_t = torch.repeat_interleave(
                self.net_t.encode(self.dt), 3 * M, 0)

    # -- the JAX side --------------------------------------------------
    def jax_ctx(self, cfg=None):
        cfg = cfg or self.cfg_j
        valid = self.dj["valids_dense"].reshape(-1)
        sf = jnp.asarray(np.repeat(self.states, 3 * self.M, 0))
        fused = jspecs.make_guidance_loss(self.dj, self.dj, cfg,
                                          jnp.asarray(self.states), valid)
        return jdiff.make_guidance_ctx(
            jspecs.make_score_rows(self.dj, self.dj, cfg), valid, sf, fused)

    def run_jax(self, key, cfg=None, guided=True, maximize=True, cm=False,
                jit=True):
        """``pstl_tpu.diffusion.sample`` under ``key``: (controls,
        all_steps); ``cm`` passes the candidate-minor eps (the planner's
        ``cm_sampler``)."""
        cfg = cfg or self.cfg_j
        ctx = self.jax_ctx(cfg) if guided else None
        hl = self.dj["highlevel_dense"]
        cm_fn = (jnet.make_cm_eps_fn(self.params, self.dj, hl, self.feat_j,
                                     cfg) if cm else None)

        def apply_fn(e):
            return self.net_j.apply(self.params, self.dj, e,
                                    prev_feature=self.feat_j)

        def run(k):
            return jdiff.sample(k, apply_fn, self.dj, hl, self.feat_j, cfg,
                                jdiff.get_coeffs(cfg), self.n,
                                guidance_ctx=ctx, maximize=maximize,
                                cm_fn=cm_fn)

        return (jax.jit(run) if jit else run)(key)

    # -- the port's side -----------------------------------------------
    def torch_ctx(self, cfg=None):
        cfg = cfg or self.cfg_t
        valid = self.dt["valids_dense"].reshape(-1)
        sf = torch.as_tensor(np.repeat(self.states, 3 * self.M, 0))
        fused = tspecs.make_guidance_loss(self.dt, self.dt, cfg,
                                          torch.as_tensor(self.states), valid)
        return tdiff.make_guidance_ctx(
            tspecs.make_score_rows(self.dt, self.dt, cfg), valid, sf, fused)

    def noise(self, key, cfg=None):
        """The JAX key chain's draws in the port sampler's layout."""
        cfg = cfg or self.cfg_t
        return jax_cm_noise(key, tdiff.n_draws(cfg),
                            tdiff.draw_layout(cfg, self.bs, 3 * self.M))

    def run_torch(self, noise, cfg=None, guided=True, maximize=True,
                  cm=False, generator=None):
        """``pstl_tpu_torch.diffusion.sample`` on ``noise`` (or the
        generator's draws when None)."""
        cfg = cfg or self.cfg_t
        ctx = self.torch_ctx(cfg) if guided else None
        hl = self.dt["highlevel_dense"]
        with torch.no_grad():
            cm_fn = (tnet.make_cm_eps_fn(self.net_t, self.dt, hl,
                                         self.feat_t, cfg) if cm else None)
            return tdiff.sample(
                lambda e: self.net_t(self.dt, e, prev_feature=self.feat_t),
                hl, cfg, tdiff.get_coeffs(cfg), self.n, noise=noise,
                generator=generator, stlp_dense=self.dt["stlp_dense"],
                guide=ctx, maximize=maximize, cm_fn=cm_fn)
