"""The ``transformer_lm`` family: ``horovod_tpu_torch.models.TransformerLM``
trained on next-token prediction.

Builds the program's model from a GPT-2 style configuration, draws its
weights from the seed (``frozen/weights.py``, the spec of
``reference/transformer_lm.py``), feeds token batches from the frozen
generator, and counts the model's operations.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss

from ..frozen import roofline, tokens, weights
from ..reference import transformer_lm as reference

UNIT = "tokens"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict) -> TransformerConfig:
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], num_layers=cfg["n_layer"],
        num_heads=cfg["n_head"], d_model=cfg["n_embd"], d_ff=cfg["n_inner"],
        max_seq_len=cfg["n_positions"], dtype=DTYPES[cfg["compute_dtype"]],
        attn_mode=cfg["attn_mode"])


def build(cfg: dict, seed: int, device) -> torch.nn.Module:
    """The program's model on ``device`` with the seed's weights."""
    model = TransformerLM(model_config(cfg), device=device)
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
    ``seq_len`` token ids, its own stream of the frozen generator."""
    ids = tokens.synthetic_tokens(traffic["batch_per_rank"],
                                  traffic["seq_len"], cfg["vocab_size"],
                                  [seed, rank, index])
    return torch.from_numpy(ids).to(device)


def loss(model, tokens_):
    return lm_loss(model(tokens_), tokens_)


def items(traffic: dict) -> int:
    """Tokens one rank trains on in a step."""
    return traffic["batch_per_rank"] * traffic["seq_len"]


def matmul_params(cfg: dict) -> int:
    """Parameters that take part in a matrix product: the projections of
    every block and the head (not the embeddings)."""
    d, f = cfg["n_embd"], cfg["n_inner"]
    return cfg["n_layer"] * (4 * d * d + 2 * d * f) + d * cfg["vocab_size"]


def flops_per_step(cfg: dict, traffic: dict) -> float:
    """Model operations of one rank's step, forward and backward, with no
    recompute: ``6`` per matmul parameter and token, plus causal
    attention, ``12 d_model`` per live (query, key) pair and layer (``4
    d`` for QK^T and PV forward, twice that backward)."""
    b, s = traffic["batch_per_rank"], traffic["seq_len"]
    pairs = roofline.unmasked_pairs(s, s, 0, 0, True)
    attn = 12 * cfg["n_embd"] * pairs * cfg["n_layer"] * b
    return 6.0 * matmul_params(cfg) * b * s + attn


def flash_launch(cfg: dict, traffic: dict) -> dict:
    """(flops, bytes) of each flash kernel's launch in a step: one block
    of ``batch x heads`` rows over the whole causal sequence, bf16
    operands (``parallel/sequence.py``, a sequence group of one)."""
    b, s = traffic["batch_per_rank"], traffic["seq_len"]
    bh, d = b * cfg["n_head"], cfg["n_embd"] // cfg["n_head"]
    item = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    pairs = bh * roofline.unmasked_pairs(s, s, 0, 0, True)
    return roofline.flash_work(bh, s, s, d, pairs, item)
