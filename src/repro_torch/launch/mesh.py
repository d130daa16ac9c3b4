"""Mesh construction, ported from the JAX package's ``launch/mesh.py``.

FUNCTIONS, never module constants, so importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the process group the
caller brought up (``torch.distributed.init_process_group``: NCCL on the
card, gloo on the CPU, the ``fake`` backend for the dry run), whose world
size must be the mesh's size."""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_mesh(shape, axes=("data", "model"), device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on ``device_type``."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh: 16x16 = 256 devices
    per pod; ``multi_pod`` adds the 2-pod outer axis."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh (:func:`production_shape`) on ``device_type``."""
    return make_mesh(*production_shape(multi_pod), device_type)


def make_cpu_mesh(n_data: int = 1, n_model: int = 1):
    """Small test mesh on the CPU (gloo)."""
    return make_mesh((n_data, n_model), ("data", "model"), "cpu")
