"""The ``deepseek_v3_lm`` family: ``horovod_tpu_torch.models.DeepseekV3LM``
(multi-head latent attention, the dropless expert layer) trained on
next-token prediction.

Builds the program's model from a DeepSeek-V3 style configuration, one
chip's share of it (``n_routed_experts`` is the count held here,
``router_outputs`` the router's published width), draws its weights from
the seed (``frozen/weights.py``, the spec of ``reference/deepseek_v3_lm.py``),
feeds token batches from the frozen generator over the vocabulary slice,
and counts the model's operations.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.models import DeepseekV3Config, DeepseekV3LM, lm_loss

from ..frozen import roofline, tokens, weights
from ..reference import deepseek_v3_lm as reference

UNIT = "tokens"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict) -> DeepseekV3Config:
    return DeepseekV3Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        first_k_dense=cfg["first_k_dense_replace"],
        intermediate_size=cfg["intermediate_size"],
        moe_intermediate_size=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["router_outputs"],
        n_held_experts=cfg["n_routed_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        n_shared_experts=cfg["n_shared_experts"],
        routed_scaling_factor=cfg["routed_scaling_factor"],
        num_heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=cfg["rope_theta"], balance_alpha=cfg["balance_alpha"],
        dtype=DTYPES[cfg["compute_dtype"]], attn_mode=cfg["attn_mode"])


def build(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The program's model on ``device`` with the seed's weights."""
    model = DeepseekV3LM(model_config(cfg), device=device)
    spec = reference.param_spec(cfg)
    params = dict(model.named_parameters())
    got = {n: tuple(p.shape) for n, p in params.items()}
    want = {n: tuple(s) for n, s, _ in spec}
    if got != want:
        raise RuntimeError(f"the program's parameters differ from the "
                           f"spec: {sorted(set(got) ^ set(want))[:8]}")
    weights.fill(params, spec, seed)
    return model


def optimizer(cfg: dict, model) -> torch.optim.Optimizer:
    hp = cfg["optimizer"]
    return torch.optim.Adam(model.parameters(), lr=hp["lr"],
                            betas=tuple(hp["betas"]), eps=hp["eps"])


def batch(cfg: dict, traffic: dict, seed: int, rank: int, index: int,
          device) -> torch.Tensor:
    """Batch ``index`` of ``rank``: ``batch_per_rank`` sequences of
    ``seq_len`` token ids of the vocabulary slice, its own stream of the
    frozen generator."""
    ids = tokens.synthetic_tokens(traffic["batch_per_rank"],
                                  traffic["seq_len"], cfg["vocab_size"],
                                  [seed, rank, index])
    return torch.from_numpy(ids).to(device)


def loss(model, tokens_):
    return lm_loss(model(tokens_), tokens_) + model.balance_loss()


def items(traffic: dict) -> int:
    """Tokens one rank trains on in a step."""
    return traffic["batch_per_rank"] * traffic["seq_len"]


def matmul_params_per_token(cfg: dict) -> float:
    """Parameters a token meets in matrix products: every layer's
    attention projections, the dense layers' MLP, each expert layer's
    router, shared experts and its held experts at the expected share of
    picks that land on them (``num_experts_per_tok`` times the held share
    of the router's experts: 6 x 8 / 64 = 0.75 evaluations a token), and
    the head (not the embedding)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    lora = cfg["kv_lora_rank"]
    attn = (d * h * (nope + rope) + d * (lora + rope)
            + lora * h * (nope + dv) + h * dv * d)
    f = cfg["moe_intermediate_size"]
    picks = (cfg["num_experts_per_tok"] * cfg["n_routed_experts"]
             / cfg["router_outputs"])
    moe = (3 * d * f * (picks + cfg["n_shared_experts"])
           + d * cfg["router_outputs"])
    dense = 3 * d * cfg["intermediate_size"]
    n, k = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    return n * attn + k * dense + (n - k) * moe + d * cfg["vocab_size"]


def flops_per_step(cfg: dict, traffic: dict) -> float:
    """Model operations of one rank's step, forward and backward, with no
    recompute: ``6`` per matmul parameter a token meets, plus causal
    attention, ``6 (d_qk + d_v)`` per live (query, key) pair, head and
    layer (``2 (d_qk + d_v)`` for q k^T and p v forward, twice that
    backward)."""
    b, s = traffic["batch_per_rank"], traffic["seq_len"]
    pairs = roofline.unmasked_pairs(s, s, 0, 0, True)
    widths = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
              + cfg["v_head_dim"])
    attn = (6 * widths * pairs * cfg["num_attention_heads"]
            * cfg["num_hidden_layers"] * b)
    return 6.0 * matmul_params_per_token(cfg) * b * s + attn


def flash_launch(cfg: dict, traffic: dict) -> dict:
    """(flops, bytes) of each flash kernel's launch in a step, at the
    unequal widths (q and k ``d_qk``, v ``d_v``): one block of ``batch x
    heads`` rows over the whole causal sequence (a sequence group of one),
    each input read and each output written once, bf16 operands; the
    forward reads and writes float32 carries (m, l, acc), the backward
    reads dout, lse and D in float32 and writes float32 gradients."""
    b, s = traffic["batch_per_rank"], traffic["seq_len"]
    bh = b * cfg["num_attention_heads"]
    dqk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    dv = cfg["v_head_dim"]
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    pairs = bh * roofline.unmasked_pairs(s, s, 0, 0, True)
    qkv = bh * s * (2 * dqk + dv) * item
    carry = bh * s * (dv + 2) * 4
    grad_in = qkv + bh * s * (dv + 2) * 4
    return {"flash_fwd": (2 * (dqk + dv) * pairs, qkv + 2 * carry),
            "flash_bwd_dq": ((4 * dqk + 2 * dv) * pairs,
                             grad_in + bh * s * dqk * 4),
            "flash_bwd_dkv": (4 * (dqk + dv) * pairs,
                              grad_in + bh * s * (dqk + dv) * 4)}
