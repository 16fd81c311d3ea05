"""Parallelism schedules of the PyTorch port: sequence parallelism
(ring and Ulysses attention), expert parallelism (``moe_alltoall``),
pipeline parallelism (``pipeline_apply``) and the composed rank layout whose
data axes the gradient sync reduces over (``mesh``)."""

from .mesh import (DATA_AXES, DCN_AXIS, ICI_DP_AXIS, MODEL_AXIS_ROLES,
                   MeshLayout, MeshLayoutError, composed_mesh,
                   default_layout, layout, mesh_for_axes, mesh_layout,
                   parse_axes, resolve_data_axes, sync_gradients)
from .moe import load_balance_loss, moe_alltoall, route_top_k
from .pipeline import microbatch, pipeline_apply
from .sequence import (heads_to_seq, ring_attention, ring_schedule,
                       seq_to_heads, ulysses_attention, zigzag_schedule,
                       zigzag_shard, zigzag_unshard)

__all__ = ["heads_to_seq", "ring_attention", "ring_schedule", "seq_to_heads",
           "ulysses_attention", "zigzag_schedule", "zigzag_shard",
           "zigzag_unshard", "moe_alltoall", "route_top_k",
           "load_balance_loss", "pipeline_apply", "microbatch",
           "DATA_AXES", "DCN_AXIS", "ICI_DP_AXIS", "MODEL_AXIS_ROLES",
           "MeshLayout", "MeshLayoutError", "composed_mesh",
           "default_layout", "layout", "mesh_for_axes", "mesh_layout",
           "parse_axes", "resolve_data_axes", "sync_gradients"]
