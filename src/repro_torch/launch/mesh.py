"""Device meshes over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``: a mesh of ``data`` x ``model``
ranks, ``model`` the expert-parallel axis of the MoE layers
(``models/moe.py``). It is a :class:`torch.distributed.device_mesh.DeviceMesh`,
and the reference's names map onto it so:

  ``mesh.shape[a]``           -> :func:`axis_size` (``mesh.size(i)``)
  ``lax.axis_index(a)``       -> :func:`axis_index` (``mesh.get_local_rank(a)``)
  a collective over axis ``a`` -> ``mesh.get_group(a)``
  a collective over every axis -> :func:`all_axes_group`

Nothing here starts a process group: the caller calls
``torch.distributed.init_process_group`` first (``nccl`` on the card,
``gloo`` on the CPU, with its own ``init_method``, rank and world size).
``make_production_mesh`` (the reference's 16 x 16 and 2 x 16 x 16 TPU
meshes, and their ``pod`` and ``data2`` axes) is not here: it comes with
ROADMAP item 11b, and a mesh with an axis other than ``data`` and
``model`` is refused until then.
"""
from __future__ import annotations

from typing import Tuple

AXES = ("data", "model")


def make_debug_mesh(n_model: int = 4, n_data: int = 2,
                    device_type: str = "cuda"):
    """An ``(n_data, n_model)`` mesh named ``("data", "model")`` over the
    world of the process group already started, ``n_data * n_model``
    ranks. ``device_type`` is ``"cuda"`` unless the caller asks for
    ``"cpu"`` (gloo ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=AXES)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, refusing any axis but ``data`` and
    ``model``."""
    names = tuple(mesh.mesh_dim_names or ())
    other = [a for a in names if a not in AXES]
    if other:
        raise NotImplementedError(
            f"mesh axes {other} are not in this port yet: only 'data' and "
            "'model' are (the 'pod' and 'data2' axes of the production "
            "meshes come with ROADMAP item 11b)")
    return names


def axis_size(mesh, name: str) -> int:
    """Ranks along axis ``name``; 1 for an axis the mesh lacks."""
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``name``; 0 for an axis the mesh
    lacks."""
    return mesh.get_local_rank(name) if name in axis_names(mesh) else 0


def dp_axes(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a != "model")


def all_axes_group(mesh):
    """The process group of every rank of the mesh (the resident MoE path
    sums over ``model`` and ``data`` at once): the default group, which
    :func:`make_debug_mesh`'s mesh spans."""
    import torch.distributed as dist
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: the mesh must span "
                         "the process group")
    return dist.group.WORLD
