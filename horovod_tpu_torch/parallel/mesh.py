"""Composed parallelism over one rank layout (port of
``horovod_tpu/parallel/mesh.py``).

The world's ranks, in order, are laid out row-major over the axes
``dcn x ici_dp x model axes``:

* **data axes**: ``dcn`` (the nodes) and ``ici_dp`` (data parallelism
  within a node). :func:`sync_gradients` reduces over these alone,
  two-level: a reduce-scatter over ``ici_dp``, an allreduce over ``dcn``,
  an allgather over ``ici_dp`` (``ops/hierarchical.py``).
* **model axes**: ``model``/``seq``/``expert``/``stage`` (any identifier),
  carved out of the node, so a model group never leaves its node. The
  schedules (``ring_attention``/``ulysses_attention`` over ``seq``,
  ``moe_alltoall`` over ``expert``, ``pipeline_apply`` over ``stage``)
  exchange over these. :func:`sync_gradients` leaves them to its caller,
  as the reference does; ``DistributedOptimizer(mesh_spec=)``, whose hooks
  leave the caller no place between backward pass and sync, also averages
  over ``seq`` and ``expert`` (:func:`step_reducer`).

An axis of the layout is a partition of the ranks into
``torch.distributed`` groups: rank r's group along an axis holds the ranks
whose other coordinates equal r's. The port makes them with
``dist.new_group`` (``runtime.partition_groups``) rather than a torch
``DeviceMesh``: the same mechanism as the process sets and the two-level
collectives, on the CPU's gloo and the card's NCCL alike, and one group
per rank list however many layouts name it. ``dist.new_group`` is a call of
the whole world, so every rank asks for a layout's groups in the same
order. The JAX package's ``jax.sharding.Mesh`` becomes :func:`mesh_for_axes`:
this rank's group along each axis.
"""

from __future__ import annotations

import dataclasses
import math

from .. import runtime
from ..utils import envs

DCN_AXIS = "dcn"
ICI_DP_AXIS = "ici_dp"
DATA_AXES = (DCN_AXIS, ICI_DP_AXIS)
MODEL_AXIS_ROLES = ("model", "seq", "expert", "stage")
# the model axes whose ranks hold every parameter whole
REPLICATED_AXES = ("seq", "expert")


class MeshLayoutError(ValueError):
    """A layout cannot be realized on this world: axis sizes that do not
    multiply to the world, a model-axis carve that does not divide the
    node, or a malformed ``HVD_MESH_AXES`` spec."""


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """One layout: ``dcn x ici_dp x model axes``. ``model_axes`` is an
    ordered tuple of ``(name, size)`` pairs carved from the node (they
    index faster than ``ici_dp``)."""

    dcn: int
    ici_dp: int
    model_axes: tuple = ()

    def __post_init__(self):
        model = tuple((str(n), int(s)) for n, s in self.model_axes)
        object.__setattr__(self, "model_axes", model)
        if self.dcn < 1 or self.ici_dp < 1:
            raise MeshLayoutError(
                f"data axis sizes must be >= 1, got dcn={self.dcn} "
                f"ici_dp={self.ici_dp}")
        names = [n for n, _ in model]
        for n, s in model:
            if s < 1:
                raise MeshLayoutError(f"model axis {n!r} size {s} < 1")
            if not n.isidentifier():
                raise MeshLayoutError(f"model axis name {n!r} is not an "
                                      "identifier")
        if len(set(names)) != len(names) or set(names) & set(DATA_AXES):
            raise MeshLayoutError(
                f"model axis names {names} must be unique and must not "
                f"collide with the data axes {DATA_AXES}")

    @property
    def axis_names(self) -> tuple:
        return DATA_AXES + tuple(n for n, _ in self.model_axes)

    @property
    def shape(self) -> tuple:
        return (self.dcn, self.ici_dp) + tuple(s for _, s in self.model_axes)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def data_axes(self) -> tuple:
        """The axes the gradient sync reduces over (and nothing else does)."""
        return DATA_AXES

    @property
    def model_axis_names(self) -> tuple:
        return tuple(n for n, _ in self.model_axes)

    def axis_size(self, name: str) -> int:
        try:
            return dict(zip(self.axis_names, self.shape))[name]
        except KeyError:
            raise MeshLayoutError(
                f"axis {name!r} not in layout {self.axis_names}") from None

    def key(self) -> tuple:
        return (self.dcn, self.ici_dp) + self.model_axes

    def axis_ranks(self, name: str, rank: int | None = None) -> list:
        """The ranks of ``rank``'s (default: this rank's) group along axis
        ``name``, in order along the axis."""
        return axis_partition(self.axis_names, self.shape, name)[
            _coord_key(self.shape, self.axis_names.index(name),
                       runtime.rank() if rank is None else rank)]


def parse_axes(spec: str) -> tuple:
    """Parse an ``HVD_MESH_AXES``-style model-axis spec: a comma list of
    ``name:size`` pairs, e.g. ``"seq:2"`` or ``"expert:4,stage:2"``.
    Empty or whitespace: no model axes."""
    spec = (spec or "").strip()
    if not spec:
        return ()
    axes = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, colon, size = part.partition(":")
        try:
            axes.append((name.strip(), int(size.strip())))
        except ValueError:
            raise MeshLayoutError(
                f"bad HVD_MESH_AXES entry {part!r}; expected name:size "
                f"(e.g. 'seq:2,expert:4')") from None
        if not colon or not name.strip():
            raise MeshLayoutError(
                f"bad HVD_MESH_AXES entry {part!r}; expected name:size")
    return tuple(axes)


def layout(model_axes=(), *, ici_size: int | None = None,
           world: int | None = None) -> MeshLayout:
    """The :class:`MeshLayout` of ``world`` ranks (default: this world):
    nodes of ``ici_size`` ranks (default ``hierarchical.default_ici_size``),
    ``dcn`` the number of nodes, and the model axes carved out of the node,
    ``ici_dp = node / prod(model sizes)``."""
    from ..ops import hierarchical
    n = runtime.size() if world is None else int(world)
    island = int(ici_size) if ici_size else hierarchical.default_ici_size()
    if island <= 0 or n % island != 0:
        raise MeshLayoutError(
            f"ici island size {island} must divide world size {n}")
    model = tuple((str(a), int(s)) for a, s in model_axes)
    carve = math.prod(s for _, s in model) if model else 1
    if carve <= 0 or island % carve != 0:
        raise MeshLayoutError(
            f"model axes {model} carve {carve} devices but the ICI "
            f"island has {island}; the product of model-axis sizes must "
            f"divide the island")
    return MeshLayout(dcn=n // island, ici_dp=island // carve,
                      model_axes=model)


def mesh_layout(model_axes=(), *, ici_size: int | None = None,
                world: int | None = None) -> MeshLayout:
    """:func:`layout` under the package-level name ``hvd.mesh_layout``."""
    return layout(model_axes, ici_size=ici_size, world=world)


def default_layout(*, world: int | None = None) -> MeshLayout:
    """The layout ``HVD_MESH_AXES`` describes for this world (no model
    axes when it is unset)."""
    return layout(parse_axes(envs.mesh_axes()), world=world)


def _coord_key(shape, axis: int, rank: int) -> tuple:
    """``rank``'s coordinates over ``shape`` with axis ``axis`` left out."""
    coords = []
    for size in reversed(shape):
        coords.append(rank % size)
        rank //= size
    coords.reverse()
    return tuple(c for i, c in enumerate(coords) if i != axis)


def axis_partition(axis_names, shape, name: str) -> dict:
    """The ranks ``0 .. prod(shape)-1`` laid out row-major over ``shape``,
    partitioned along axis ``name``: other coordinates -> the ranks along
    the axis, in order."""
    axis = tuple(axis_names).index(name)
    parts: dict = {}
    for r in range(math.prod(shape)):
        parts.setdefault(_coord_key(shape, axis, r), []).append(r)
    return parts


def mesh_for_axes(axis_names, shape) -> dict:
    """The port's mesh: this rank's ``torch.distributed`` group along each
    axis of the world's ranks laid out row-major over ``shape`` (None along
    an axis of size 1). Every rank calls it with the same axes; raises
    :class:`MeshLayoutError` when the sizes do not multiply to the
    world."""
    axis_names = tuple(axis_names)
    shape = tuple(int(s) for s in shape)
    n = runtime.size()
    if math.prod(shape) != n:
        raise MeshLayoutError(
            f"mesh axes {dict(zip(axis_names, shape))} multiply to "
            f"{math.prod(shape)} devices but the world has {n}")
    out = {}
    for i, name in enumerate(axis_names):
        if shape[i] == 1:
            out[name] = None
            continue
        parts = axis_partition(axis_names, shape, name)
        groups = dict(zip(parts, runtime.partition_groups(parts.values())))
        out[name] = groups[_coord_key(shape, i, runtime.rank())]
    return out


def composed_mesh(lay: MeshLayout | None = None) -> dict:
    """:func:`mesh_for_axes` of ``lay`` (default :func:`default_layout`)."""
    if lay is None:
        lay = default_layout()
    return mesh_for_axes(lay.axis_names, lay.shape)


def resolve_data_axes(mesh_spec) -> tuple:
    """Normalize a ``mesh_spec`` (a :class:`MeshLayout`, or a
    ``(dcn_axis, ici_axis)`` name pair) to its data-axis names."""
    if isinstance(mesh_spec, MeshLayout):
        return mesh_spec.data_axes
    if (isinstance(mesh_spec, (tuple, list)) and len(mesh_spec) == 2
            and all(isinstance(a, str) for a in mesh_spec)):
        return tuple(mesh_spec)
    raise MeshLayoutError(
        f"mesh_spec must be a MeshLayout or a (dcn_axis, ici_axis) name "
        f"pair, got {mesh_spec!r}")


def layout_of(mesh_spec) -> MeshLayout:
    """The layout a ``mesh_spec`` names: itself, or for the name pair of
    the data axes, :func:`default_layout`."""
    if isinstance(mesh_spec, MeshLayout):
        return mesh_spec
    names = resolve_data_axes(mesh_spec)
    if names != DATA_AXES:
        raise MeshLayoutError(
            f"the port reduces over a layout's data axes {DATA_AXES}; got "
            f"{names}")
    return default_layout()


def _check_op(op, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0):
    """``op`` (default AVERAGE) if the two-level sync takes it; Adasum
    takes no scale factors (reference ``mesh.py``)."""
    from ..ops.reduce_ops import ReduceOp
    op = ReduceOp.AVERAGE if op is None else op
    if op == ReduceOp.ADASUM:
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError("Adasum is scale-invariant; pre/post scale "
                             "factors do not apply")
        return op
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"hierarchical allreduce supports SUM/AVERAGE, got {op.name}")
    return op


def sync_gradients(tree, lay: MeshLayout | None = None, *, op=None,
                   prescale_factor: float = 1.0,
                   postscale_factor: float = 1.0):
    """Two-level gradient sync over the data axes of ``lay`` (default
    :func:`default_layout`): every tensor of ``tree`` (a tensor, or a
    nested list, tuple or dict of them) reduced over ``ici_dp`` then
    ``dcn``, fused as ``grouped_allreduce`` fuses, with the pre/post scale
    split of the two-level allreduce; AVERAGE divides by ``dcn * ici_dp``.
    Returns a tree of new tensors. The model axes are untouched, as in the
    reference: a gradient that a ``seq`` or ``expert`` axis replicates
    covers this rank's tokens alone, and is the caller's to average over
    that axis first (the reference's composed step does it with ``pmean``;
    ``DistributedOptimizer(mesh_spec=)`` does both). ``ReduceOp.ADASUM``
    sums over ``ici_dp`` and combines across ``dcn`` by Adasum, with one
    set of coefficients per tensor (``ops/adasum.py``'s two-level route);
    it takes no scale factors."""
    from ..ops import adasum, collectives, hierarchical
    from ..ops.reduce_ops import ReduceOp
    from ..optim import _flatten
    lay = default_layout() if lay is None else lay
    op = _check_op(op, prescale_factor, postscale_factor)
    groups = composed_mesh(lay)
    if op == ReduceOp.ADASUM:
        reduce = adasum.two_level_route(
            groups[ICI_DP_AXIS], lay.axis_ranks(ICI_DP_AXIS),
            lay.axis_ranks(DCN_AXIS))
    else:
        reduce = hierarchical.two_level_reducer(
            groups[ICI_DP_AXIS], groups[DCN_AXIS], lay.ici_dp, lay.dcn)
    leaves, build = _flatten(tree)
    return build(collectives._reduce_async(
        leaves, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=None,
        size=lay.dcn * lay.ici_dp, reduce=reduce).synchronize())


def step_reducer(lay: MeshLayout, op) -> tuple:
    """``(reducer, ranks)`` of ``DistributedOptimizer(mesh_spec=lay)``
    for ``collectives._reduce_async``: the reference's composed step, its
    ``pmean`` over the model axes and then the two-level sync over the
    data axes, as one two-level sum over the world. A model axis is carved
    from the node, so the node's ranks (``ici_dp`` x model axes) reduce
    first, then ``dcn``. Each ``REPLICATED_AXES`` axis holds every
    parameter whole (the MoE FFN keeps its experts replicated, with the
    grad boost that this mean undoes) and splits the tokens; any other
    model axis (``stage``'s stages) holds different parameters on its
    ranks, so it raises :class:`MeshLayoutError`. For ADASUM the reducer
    is ``ops/adasum.py``'s two-level route: the node's sum, scaled by
    ``ici_dp / node`` to the mean over the model axes, then Adasum across
    ``dcn``."""
    from ..ops import adasum, hierarchical
    from ..ops.reduce_ops import ReduceOp
    op = _check_op(op)
    other = [n for n in lay.model_axis_names if n not in REPLICATED_AXES]
    if other:
        raise MeshLayoutError(
            f"mesh_spec averages the gradients over the model axes "
            f"{REPLICATED_AXES}, whose ranks hold the same parameters; "
            f"{other} hold different ones: reduce over the data ranks with "
            f"process_set= instead")
    node = lay.size // lay.dcn
    groups = mesh_for_axes((DCN_AXIS, "node"), (lay.dcn, node))
    if op == ReduceOp.ADASUM:
        shape, axes = (lay.dcn, node), (DCN_AXIS, "node")
        of = lambda i: axis_partition(axes, shape, axes[i])[  # noqa: E731
            _coord_key(shape, i, runtime.rank())]
        return adasum.two_level_route(groups["node"], of(1), of(0),
                                      scale=lay.ici_dp / node), lay.size
    return hierarchical.two_level_reducer(
        groups["node"], groups[DCN_AXIS], node, lay.dcn), lay.size


__all__ = [
    "DCN_AXIS", "ICI_DP_AXIS", "DATA_AXES", "MODEL_AXIS_ROLES",
    "MeshLayout", "MeshLayoutError", "parse_axes", "layout",
    "mesh_layout", "default_layout", "mesh_for_axes", "composed_mesh",
    "resolve_data_axes", "sync_gradients",
]
