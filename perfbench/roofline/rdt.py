"""FLOPs of RDT-1B's diffusion transformer (``models/rdt.py``), from the
configuration's ``eps_net`` widths, 2 a multiply-add: every Linear, both
attentions' score and value products, the state adaptor on the action
tokens and the timestep embedder.  RMSNorm, QK-norm, GELU, SiLU, the
softmax and the sums are not counted.

:func:`flops` is one pass as the program's chain runs it; :func:`cond_flops`
what it builds once a plan (the frequency token, the state token, both
streams' adaptors and every cross-attention layer's K and V), which
:func:`flops` leaves out.  The two together equal
``torch.utils.flop_counter.FlopCounterMode`` on the plain reference,
which runs all of it on every row and pass
(``perfbench/tests/test_perfbench_rdt.py``)."""

from __future__ import annotations

#: the planner's streams: the scene feature's tokens and their width, the
#: rule's width; the embedders' sinusoid width
IMG_TOKENS, IMG_IN, LANG_IN, FREQ_DIM = 7, 32, 7, 256


def _blocks_of(spec: dict, stream: int) -> int:
    """Blocks that cross-attend to stream 0 (language, even blocks) or 1
    (image, odd)."""
    return (spec["depth"] + 1 - stream) // 2


def _embedder(D: int) -> int:
    return FREQ_DIM * D + D * D


def flops(spec: dict, rows: int, nt: int, step_rows: int = 1) -> float:
    """One pass over ``rows`` rows of horizon ``nt``, the timestep embedder
    on ``step_rows`` timesteps (the planner's chain: 1, every row shares
    t)."""
    D, S, out = spec["hidden_size"], spec["state_token_dim"], spec["out_dim"]
    L = nt + 3
    mac = step_rows * _embedder(D)
    mac += rows * nt * (2 * S * D + 2 * D * D)          # action tokens
    per_block = 8 * D * D * L + 2 * L * L * D           # linears, self-attn
    mac += spec["depth"] * rows * per_block
    # cross-attention scores and values: one language key, IMG_TOKENS image
    # keys
    mac += rows * 2 * L * D * (_blocks_of(spec, 0)
                               + IMG_TOKENS * _blocks_of(spec, 1))
    mac += rows * L * (D * D + D * out)                 # final layer
    return 2.0 * mac


def cond_flops(spec: dict, rows: int, scenes: int,
               freq_rows: int = 1) -> float:
    """What a plan builds once for ``rows`` rows of ``scenes`` scenes: the
    language stream's adaptor and K / V a row, the image stream's and the
    state token a scene (``scenes`` = ``rows`` where every row has its
    own) and the frequency embedder on ``freq_rows``."""
    D, S = spec["hidden_size"], spec["state_token_dim"]
    mac = freq_rows * _embedder(D)
    mac += scenes * (2 * S * D + 2 * D * D)
    mac += rows * (LANG_IN * D + D * D + _blocks_of(spec, 0) * 2 * D * D)
    mac += scenes * IMG_TOKENS * (IMG_IN * D + D * D
                                  + _blocks_of(spec, 1) * 2 * D * D)
    return 2.0 * mac
