"""Operation and byte counts that the rooflines and the ``mfu`` metrics
divide by, computed from a configuration's widths and a cell's shapes, and
the card's published peaks (``peaks.json``).

Kernel 1's count is ``chip_smoke.guidance_ops`` and its bytes are every
operand read once and every output written once (``chip_smoke.nbytes`` of
a launch's arguments), worked out from the shapes here.  The networks'
matmul FLOPs count 2 per multiply-add of every ``Linear`` (and of the
split first layer of the candidate-minor eps MLP) that the timed path
runs forward.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
#: the Net's fixed widths (``models.net.Net``)
FEAT_DIM, STLP_DIM, TIME_DIM, LANE_DIM = 32, 6, 32, 3
MERGE_HIDDENS = (32, 32)


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def bound_s(n_bytes: float, ops: dict) -> float:
    """The least time for these bytes and operations at the peaks: the
    longer of the bytes over HBM bandwidth and, over the operand types, the
    operations over their type's rate (the pipes of two types run at once).
    """
    pk = peaks()
    t_ops = max(n / pk["ops_per_s"][k] for k, n in ops.items())
    return max(n_bytes / pk["hbm_bytes_per_s"], t_ops)


def matmul_peak(fields: dict) -> float:
    """The dense peak of the precision the configuration's matmuls run in
    (``compute_dtype``; float32 matmuls are counted at the TF32 rate only
    when the run allows TF32, which the benchmark does not)."""
    return peaks()["ops_per_s"][fields["compute_dtype"]]


# ---------------------------------------------------------------------------
# kernel 1 (csrc/guidance_fused.cu)
# ---------------------------------------------------------------------------

def guidance_ops(fields: dict, bs: int, freeze: bool = True) -> float:
    """``chip_smoke.guidance_ops``: one guidance update of ``bs`` scenes of
    R = 3 * n_randoms candidate columns, each fp32 add, multiply, compare or
    transcendental one operation.  Per column and Adam iteration a forward
    pass (the rollout ~12 per t, the frozen lane segment's distance and
    heading ~30 per t, ~20 for the clause terms and their exps per t, the
    frozen disc pair's clearance ~15 per (k, t)), a backward of about twice
    that, and Adam ~12 per control; the in-kernel freeze adds the segment
    search over the S waypoints of 3 lanes (~10 per point) per t and the
    disc-pair search per (k, t) (nL * nL pairs, or 2 * nL with the coarse
    pair, ~6 each)."""
    T, K, S = fields["nt"], fields["n_neighbors"], fields["n_segs"]
    nL = fields["refined_nL"]
    R = 3 * fields["n_randoms"]
    fwd = T * (12 + 30 + 20) + K * T * 15
    ops = fields["guidance_niters"] * (3 * fwd + 2 * T * 12)
    if freeze:
        pairs = 2 * nL if fields["clearance_coarse_pair"] else nL * nL
        ops += T * 3 * S * 10 + K * T * pairs * 6
    return float(bs * R * ops)


def guidance_bytes(fields: dict, bs: int) -> float:
    """A launch's fp32 operands read once and its outputs written once:
    muw, mua (bs, T, R) in and out; lanes (bs, 3, S, 3); the neighbor disc
    centres ndx, ndy (bs, K, nL, T); crad, cvalid (bs, K, T); stlp
    (bs, 6, R); nf (bs, 3, R); valid (bs, R); scal (bs, 2); gvec (3,)."""
    T, K, S = fields["nt"], fields["n_neighbors"], fields["n_segs"]
    nL = fields["refined_nL"]
    R = 3 * fields["n_randoms"]
    floats = (4 * bs * T * R + bs * 3 * S * 3 + 2 * bs * K * nL * T
              + 2 * bs * K * T + bs * STLP_DIM * R + bs * 3 * R + bs * R
              + bs * 2 + 3)
    return 4.0 * floats


def guidance_bound_s(fields: dict, bs: int) -> float:
    return bound_s(guidance_bytes(fields, bs),
                   {"float32": guidance_ops(fields, bs)})


# ---------------------------------------------------------------------------
# the networks' matmuls
# ---------------------------------------------------------------------------

def mlp_flops(rows: int, d_in: int, widths) -> float:
    """FLOPs of a Dense stack on ``rows`` rows: 2 a multiply-add."""
    dims = [d_in] + list(widths)
    return float(sum(2 * rows * a * b for a, b in zip(dims, dims[1:])))


def _widths(fields):
    return tuple(fields["hiddens"])


def encode_flops(fields: dict, bs: int) -> float:
    """``Net.encode`` of ``bs`` scenes: the ego (6 in), neighbor (7 in, K a
    scene) and lane (3 lanes of S * 3 in) encoders."""
    h = _widths(fields) + (FEAT_DIM,)
    K, S = fields["n_neighbors"], fields["n_segs"]
    return (mlp_flops(bs, 6, h) + mlp_flops(bs * K, 7, h)
            + mlp_flops(bs * 3, S * LANE_DIM, h))


def denoise_steps(fields: dict) -> int:
    """Eps evaluations of the DDPM chain: diffusion_steps - 1."""
    return int(fields["diffusion_steps"]) - 1


def rect_flops(fields: dict, rows: int) -> float:
    """One ``Net.rect`` pass: the merge net (with ``diverse_loss``) and the
    RefineNet MLP on ``rows`` rows."""
    D = fields["nt"] * 2
    rect_in = 7 * FEAT_DIM + 1 + STLP_DIM + D
    out = 0.0
    if fields["diverse_loss"] and not fields["no_arch"]:
        out += mlp_flops(rows, D, MERGE_HIDDENS + (D,))
        if fields["diverse_fuse_type"] == "cat":
            rect_in += D
    out += mlp_flops(rows, rect_in, tuple(fields["rect_hiddens"]) + (D,))
    return out


def plan_flops(fields: dict, bs: int) -> float:
    """Matmul FLOPs of one closed-loop plan step of ``bs`` scenes on the
    candidate-minor DDPM chain (``sim.make_planner``): the encoders; the
    eps MLP's first layer split by input block, its scene block (feature,
    high level, stlp) once a plan and its time and noise blocks at every
    denoise step with the other layers; and with ``rect_head`` the
    RefineNet pass and its ``n_rolls`` re-rectifications."""
    h = _widths(fields)
    D = fields["nt"] * 2
    n = bs * fields["n_randoms"] * 3
    F = 7 * FEAT_DIM
    total = encode_flops(fields, bs)
    total += 2 * n * (F + 1 + STLP_DIM) * h[0]
    if fields["use_init_hint"]:
        total += 2 * n * D * h[0]
    per_step = 2 * TIME_DIM * h[0] + 2 * n * D * h[0]
    per_step += sum(2 * n * a * b for a, b in zip(h, h[1:]))
    per_step += 2 * n * h[-1] * D
    total += denoise_steps(fields) * per_step
    if fields["rect_head"] and not fields["not_use_rect"]:
        total += (1 + int(fields["n_rolls"] or 0)) * rect_flops(fields, n)
    return float(total)
