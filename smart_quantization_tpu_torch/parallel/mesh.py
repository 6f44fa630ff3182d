"""The (data, fsdp) mesh of ranks and the FSDP shard rule.

Counterpart of ``smart_quantization_tpu/parallel/mesh.py``.  The JAX mesh
is ``np.asarray(devices).reshape(dp, fsdp)``; here the devices are the
ranks of the default process group, laid out the same way:

    rank = data index * fsdp + fsdp index

Three process groups take the place of the mesh's axis names: ``data``
(the ranks of one fsdp index), ``fsdp`` (the ranks of one data index) and
the world.  A collective over a tuple of axes runs over each group in turn
(``parallel/collectives.py``).

:func:`fsdp_shard_axis` is the JAX package's rule: the largest axis of the
shape that the fsdp size divides, the last one on a tie.  It is applied to
the JAX layout of a leaf (a flax Dense kernel is ``(in, out)``, a torch
``Linear.weight`` ``(out, in)``), and :func:`shard_dim` maps its answer to
the torch dim through ``convert.jax_axes``, so that every shard holds the
same elements as the JAX package's and the per-shard SmaQ statistics agree.
"""

from __future__ import annotations

import dataclasses

from smart_quantization_tpu_torch.convert import jax_axes

AXES = ("data", "fsdp")


def fsdp_shard_axis(shape: tuple[int, ...], fsdp_size: int) -> int:
    """Index of the largest fsdp-divisible axis of ``shape``, or -1 to
    replicate (the last such axis on a tie)."""
    if fsdp_size == 1:
        return -1
    candidates = [(dim, i) for i, dim in enumerate(shape) if dim and dim % fsdp_size == 0]
    if not candidates:
        return -1
    return max(candidates)[1]


def shard_dim(name: str, shape: tuple[int, ...], fsdp_size: int) -> int:
    """The torch dim of leaf ``name`` (of torch ``shape``) that FSDP
    shards, or -1 to replicate: :func:`fsdp_shard_axis` on the JAX layout,
    mapped back."""
    axes = jax_axes(name, len(shape))
    axis = fsdp_shard_axis(tuple(shape[a] for a in axes), fsdp_size)
    return -1 if axis < 0 else axes[axis]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's sizes: ``dp`` data-parallel rows of ``fsdp`` ranks each."""

    dp: int
    fsdp: int = 1

    def __post_init__(self):
        if self.dp < 1 or self.fsdp < 1:
            raise ValueError(f"mesh sizes must be 1 or more, got dp={self.dp} fsdp={self.fsdp}")

    @property
    def size(self) -> int:
        return self.dp * self.fsdp

    def coords(self, rank: int) -> tuple[int, int]:
        """(data index, fsdp index) of ``rank``."""
        return divmod(rank, self.fsdp)

    def data_ranks(self, fsdp_index: int) -> list[int]:
        """The ranks of one ``data`` group (those of one fsdp index)."""
        return [d * self.fsdp + fsdp_index for d in range(self.dp)]

    def fsdp_ranks(self, data_index: int) -> list[int]:
        """The ranks of one ``fsdp`` group (those of one data index)."""
        return [data_index * self.fsdp + j for j in range(self.fsdp)]


def plan_mesh(dp: int | None, fsdp: int | None, world: int | None = None) -> MeshShape | None:
    """The mesh a command line asks for (``--dp``, ``--fsdp``): None
    for no mesh (``--dp`` 1 or absent and ``--fsdp`` 1, as in the JAX
    package), else its shape; ``dp`` absent fills ``world`` ranks."""
    fsdp = fsdp or 1
    if (dp is None or dp <= 1) and fsdp <= 1:
        return None
    if dp is None:
        dp = (world or fsdp) // fsdp
    shape = MeshShape(dp, fsdp)
    if world is not None and shape.size != world:
        raise ValueError(f"dp({dp}) * fsdp({fsdp}) != world size ({world})")
    return shape


class Mesh:
    """This rank's place on a (data, fsdp) mesh over the default process
    group, with its three groups.  Built by :func:`make_mesh` on every rank
    (creating a group is collective)."""

    def __init__(self, shape: MeshShape, rank: int, groups: dict):
        self.shape = {"data": shape.dp, "fsdp": shape.fsdp}
        self.size = shape.size
        self.rank = rank
        self.data_index, self.fsdp_index = shape.coords(rank)
        self._groups = groups

    @property
    def fsdp_active(self) -> bool:
        return self.shape["fsdp"] > 1

    def group(self, axes):
        """The process group of one axis name, or a tuple of groups for a
        tuple of names (the world for both axes)."""
        if isinstance(axes, (tuple, list)):
            if tuple(axes) in (AXES, AXES[::-1]):
                return self._groups["world"]
            return tuple(self._groups[a] for a in axes)
        return self._groups[axes]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['data']}, fsdp={self.shape['fsdp']}, rank={self.rank}, "
                f"data={self.data_index}, fsdp_index={self.fsdp_index})")


def make_mesh(dp: int | None = None, fsdp: int = 1) -> Mesh:
    """The mesh over the default process group's ranks; ``dp`` defaults to
    the world size over ``fsdp``.  Every rank calls it in the same order.
    Without a process group, a (1, 1) mesh is one device, as in JAX: no
    group, no collective."""
    import torch.distributed as dist

    if not dist.is_initialized():
        if (dp or 1) * fsdp != 1:
            raise ValueError(f"a mesh of dp={dp} fsdp={fsdp} needs a process group")
        return Mesh(MeshShape(1, 1), 0, {"world": None, "data": None, "fsdp": None})
    world = dist.get_world_size()
    shape = plan_mesh(dp if dp is not None else world // fsdp, fsdp, world) or MeshShape(1, 1)
    if shape.size != world:
        raise ValueError(f"dp({shape.dp}) * fsdp({shape.fsdp}) != world size ({world})")
    rank = dist.get_rank()
    data_index, fsdp_index = shape.coords(rank)
    groups = {"world": dist.group.WORLD}
    # every rank creates every group, in one order
    for j in range(shape.fsdp):
        g = dist.new_group(shape.data_ranks(j))
        if j == fsdp_index:
            groups["data"] = g
    for d in range(shape.dp):
        g = dist.new_group(shape.fsdp_ranks(d))
        if d == data_index:
            groups["fsdp"] = g
    return Mesh(shape, rank, groups)
