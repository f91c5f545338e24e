"""A frozen copy of ``pstl_tpu_torch/config.py`` of the PyTorch port, kept as the benchmark's plain
reference: every kernel dispatch runs the plain version.  Do not edit to
follow the program."""


from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


#: what the frozen copy raises for a path that no cell of the benchmark runs
HELD = "the frozen copy holds the benchmark's paths only"


@dataclass(frozen=True)
class Config:
    # ---- experiment ----------------------------------------------------
    seed: int = 1007
    exp_name: Optional[str] = None
    epochs: int = 500
    test: bool = False
    net_pretrained_path: Optional[str] = None
    batch_size: int = 128
    lr: float = 3e-4
    hiddens: Tuple[int, ...] = (256, 256)
    print_freq: int = 10
    save_freq: int = 100
    viz_freq: int = 50
    num_viz: int = 10
    no_viz: bool = False
    mini: bool = False
    train_ratio: float = 0.7

    # ---- scene tensor shapes -------------------------------------------
    n_neighbors: int = 8
    n_randoms: int = 64
    n_segs: int = 15
    n_expands: int = 4

    # ---- dynamics & geometry -------------------------------------------
    ego_L: float = 4.084
    ego_W: float = 1.730
    refined_nL: int = 4
    refined_nW: int = 1
    nt: int = 20
    dt: float = 0.5
    mul_w_max: float = 0.5
    mul_a_max: float = 5.0

    # ---- STL semantics ---------------------------------------------------
    smoothing_factor: float = 100.0
    clip_dist: bool = False
    inline: bool = False
    norm_stl: bool = False
    flex: bool = False
    stl_nn_thres: float = 0.0005
    stl_trajopt_thres: float = 0.01

    # ---- data ------------------------------------------------------------
    collect_data: bool = False
    offline: bool = True
    cache_path: str = "e0_nusc_cache"
    params_load_path: Optional[str] = "e1_nusc_trajopt"
    load_stlp: bool = False
    load_tj: bool = False
    gt_nei: bool = True
    generate_split_on_the_fly: bool = False
    synthetic: bool = True
    n_synth_scenes: int = 512
    synth_low_speed_frac: float = 0.0

    # ---- trajopt augmentation ---------------------------------------------
    trajopt_only: bool = False
    traj_opt_iters: int = 2000
    trajopt_lr: float = 0.005
    opt_epochs: int = 0
    reg_loss: float = 10.0
    trajopt_robust_draws: int = 4
    trajopt_nonneg_speed: float = 0.0

    # ---- model modes -------------------------------------------------------
    stl_weight: float = 1.0
    bc: bool = False
    bc_weight: float = 0.0
    vae: bool = False
    vae_dim: int = 64
    weight_vae_bc: float = 1.0
    weight_vae_kl: float = 1.0
    diffusion: bool = False
    diffusion_steps: int = 100
    beta_start: float = 1e-4
    beta_end: float = 0.02
    cos: bool = True
    sampler: str = "ddpm"
    ddim_steps: int = 20
    ddim_eta: float = 0.0
    fast_guided_focus: float = 0.0
    fast_focus_band: int = 0
    grad_rollout: bool = False
    use_init_hint: bool = False
    gt_data_training: bool = False
    stl_bc_mask: bool = True

    # ---- RefineNet ----------------------------------------------------------
    rect_head: bool = False
    rect_hiddens: Tuple[int, ...] = (256, 256)
    rect_reg_loss: float = 0.0
    joint: bool = False
    extra_rect_reg: Optional[float] = None
    not_use_rect: bool = False
    interval: bool = False
    clip_rect: bool = False
    diffusion_clip: bool = False
    diff_full: bool = False
    multi_cands: Optional[int] = None
    n_rolls: Optional[int] = None
    no_refinenet: bool = False

    # ---- diversity -------------------------------------------------------
    diverse_loss: bool = False
    diversity_weight: float = 1.0
    diversity_scale: float = 1.0
    no_arch: bool = False
    n_shards: int = 4
    diverse_fuse_type: str = "add"
    diverse_detach: bool = False
    measure_diversity: bool = False
    extra_diversity: bool = False

    # ---- guidance (CTG-style) ----------------------------------------------
    guidance: bool = False
    guidance_niters: int = 3
    guidance_before: int = 1000
    guidance_lr: float = 0.01
    guidance_reverse: bool = False
    guidance_sets: Optional[Tuple[int, ...]] = None
    guidance_freq: Optional[int] = None
    guidance_positive_offset_quirk: bool = False
    sample_noise_scale: float = 1.0

    # ---- losses extras ------------------------------------------------------
    collision_loss: Optional[float] = None
    oracle_filter: bool = False

    # ---- evaluation ----------------------------------------------------------
    run_sampling_test: bool = False
    sampling_size: int = 64
    n_trials: int = 100
    refinement: bool = False
    raw_refinement: bool = False
    lite_refine: bool = False
    backup: bool = False
    backup_niters: int = 500
    forward_shield: bool = True
    env_nonnegative_speed: bool = True
    test_scenes: bool = False
    test_aggressive: bool = False

    # ---- execution (TPU layout levers are accepted and ignored) -------------
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    compute_dtype: str = "bfloat16"
    robustness_dtype: str = "float32"
    geometry_dtype: str = "float32"
    cm_sampler: bool = True
    diffusion_scan_unroll: int = 1
    clearance_coarse_pair: bool = False
    cm_broadcast_dots: bool = True
    tiled_scorer: bool = True
    guidance_fused_loss: bool = True
    guidance_remat: bool = False
    guidance_reuse_selection: bool = False
    guidance_sel_every: int = 1
    use_pallas_clearance: bool = False
    guidance_blend_scores: bool = False
    # the guidance_pallas* family names the guidance kernels; on the port
    # it selects ops/guidance_kernel.py (csrc/guidance_fused.cu with
    # fuse_freeze, csrc/guidance_frozen.cu without)
    guidance_pallas: bool = False
    guidance_pallas_fuse_freeze: bool = False
    guidance_pallas_fold: bool = False
    guidance_pallas_cols: int = 0
    guidance_pallas_fold2: bool = False
    guidance_pallas_superstep: bool = False
    guidance_pallas_pack: int = 1
    guidance_pallas_bf16_cumsum: bool = False
    pallas_interpret: bool = False
    use_shard_store: bool = False
    train_chunk: int = 8
    time_profile: bool = False

    # ------------------------------------------------------------------
    @property
    def multi_check(self) -> bool:
        return (self.diffusion or self.vae or self.bc) \
            and not self.gt_data_training

    @property
    def latent_dim(self) -> int:
        stlp_dim = 6
        if self.diffusion:
            d = self.nt * 2 + 32 + 1 + stlp_dim
        elif self.vae:
            d = self.vae_dim + 1 + stlp_dim
        else:
            d = 1 + stlp_dim
        if self.use_init_hint:
            d += self.nt * 2
        return d

    def finalize(self) -> "Config":
        """The reference's flag-coupling rules (``pstl_tpu/config.py``
        ``Config.finalize``), rule for rule."""
        c = self
        upd = {}
        upd["gt_nei"] = True
        upd["stl_bc_mask"] = True
        upd["cos"] = True
        if not c.collect_data and not c.trajopt_only:
            upd["measure_diversity"] = True
        if c.run_sampling_test:
            upd["test"] = True
            upd["extra_diversity"] = True
        if c.collect_data:
            upd.update(epochs=1, batch_size=1024)
        if c.trajopt_only:
            upd.update(opt_epochs=1, epochs=1, batch_size=1024,
                       diffusion=True, flex=True)
        if c.opt_epochs > 0 or upd.get("opt_epochs", 0) > 0:
            upd["epochs"] = max(c.opt_epochs, upd.get("opt_epochs", 0))
        if c.load_stlp:
            upd["load_tj"] = True
        if c.rect_head:
            upd.update(interval=True, diffusion_clip=True, diff_full=True)
        upd["offline"] = not c.collect_data
        if c.test or upd.get("test"):
            upd["epochs"] = 1
        if c.guidance_pallas_pack > 1:
            upd["guidance_pallas_fuse_freeze"] = True
            if (c.guidance_pallas_fold or c.guidance_pallas_fold2
                    or c.guidance_pallas_superstep):
                raise ValueError(
                    "guidance_pallas_pack is mutually exclusive with the "
                    "folded kernel variants (fold/fold2/superstep)")
        if c.guidance_pallas_superstep:
            upd["guidance_pallas_fold2"] = True
            if not c.cm_sampler:
                raise ValueError("guidance_pallas_superstep needs cm_sampler")
        if c.guidance_pallas_fold2 or upd.get("guidance_pallas_fold2"):
            upd["guidance_pallas_fuse_freeze"] = True
        if c.guidance_pallas_fuse_freeze or upd.get(
                "guidance_pallas_fuse_freeze"):
            upd["guidance_pallas"] = True
            if c.guidance_sel_every != 1:
                raise ValueError(
                    "guidance_pallas_fuse_freeze re-freezes every guided "
                    "step; guidance_sel_every must be 1")
        if c.guidance_pallas or upd.get("guidance_pallas"):
            upd.update(guidance_reuse_selection=True,
                       guidance_fused_loss=True, tiled_scorer=True)
            if c.robustness_dtype != "float32":
                raise ValueError("the fused guidance kernel computes fp32 "
                                 "robustness; robustness_dtype must stay "
                                 "float32 with it")
        return replace(c, **upd)
