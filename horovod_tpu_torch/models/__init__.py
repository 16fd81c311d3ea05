"""Models of the PyTorch port."""

from .transformer import (TransformerConfig, TransformerLM, from_flax_params,
                          lm_loss)

__all__ = ["TransformerConfig", "TransformerLM", "from_flax_params",
           "lm_loss"]
