# Copyright 2026 The container-engine-accelerators-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Device meshes over the ranks of a ``torch.distributed`` world
(counterpart of container_engine_accelerators_tpu/parallel/mesh.py).

The JAX module lays the visible devices out as a ``jax.sharding.Mesh``
with ("data", "model") axes. Here a device is a rank: one process per
device, a CUDA card under NCCL or a CPU process under gloo, and a mesh
is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's
ranks with the same axis names, laid out data-major, so neighbouring
model-axis peers are adjacent ranks (adjacent cards of one host under
the usual launch order). Every rank of the world must build the same
mesh: the axis groups are made collectively.

``named_mesh`` builds a mesh of any shape and axis names (the
multichip dryrun's ("data", "context", "expert") mesh); ``grid_mesh``
is its two-axis form.

The process group must exist first (``distributed.
initialize_from_plugin_env``, or ``torch.distributed.
init_process_group``); the mesh's device type follows its backend:
"cuda" under NCCL, "cpu" under gloo.
"""

import dataclasses
import logging

from ..utils import env_str

DATA_AXIS = "data"
MODEL_AXIS = "model"

log = logging.getLogger(__name__)


@dataclasses.dataclass
class MeshSpec:
    """How to factor the world's ranks into (data, model)."""

    data: int
    model: int = 1

    @property
    def size(self):
        return self.data * self.model


def chips_from_env():
    """Chip indices granted by the device plugin, or None.

    Reads ``TPU_VISIBLE_DEVICES`` (a comma-separated index list), as
    the plugin's Allocate response injects it into the container's
    environment; unset, empty or junk gives None."""
    raw = env_str("TPU_VISIBLE_DEVICES", "")
    if not raw:
        return None
    try:
        return [int(tok) for tok in raw.split(",") if tok != ""]
    except ValueError:
        return None


def default_spec(n_devices, model_parallelism=1):
    if n_devices % model_parallelism != 0:
        raise ValueError(
            f"{n_devices} devices do not factor into model={model_parallelism}")
    return MeshSpec(data=n_devices // model_parallelism,
                    model=model_parallelism)


def world_ranks():
    """Every rank of the initialized world, in order."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a torch.distributed process group: call "
            "distributed.initialize_from_plugin_env() or "
            "torch.distributed.init_process_group() first")
    return list(range(dist.get_world_size()))


def mesh_device_type():
    """The DeviceMesh device type of the world's backend: "cuda" under
    NCCL, "cpu" otherwise."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def named_mesh(shape, axis_names, devices=None):
    """A DeviceMesh of ``shape`` named ``axis_names`` over the world's
    ranks (or ``devices``, a rank list), laid out row-major: the JAX
    ``Mesh(np.array(devices).reshape(shape), axis_names)``, the last
    axis varying fastest. As ``grid_mesh``: a shape that names more
    ranks than exist is an error; one that names fewer takes the
    leading ranks (the others hold no coordinate in it, and warn)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    devices = list(devices if devices is not None else world_ranks())
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(
            axis_names):
        raise ValueError(f"mesh shape {shape} needs as many distinct axis "
                         f"names: {axis_names}")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh factors must be >= 1: {shape}")
    size = 1
    for n in shape:
        size *= n
    dims = "x".join(str(n) for n in shape)
    if size > len(devices):
        raise ValueError(
            f"mesh spec {dims} needs {size} devices; only {len(devices)} "
            f"visible")
    if size < len(devices):
        log.warning("mesh %s uses %d of %d visible devices", dims, size,
                    len(devices))
    grid = torch.tensor(devices[:size], dtype=torch.int64).reshape(shape)
    return DeviceMesh(mesh_device_type(), grid, mesh_dim_names=axis_names)


def grid_mesh(devices, major, minor, minor_axis):
    """Factor ranks into a row-major (DATA_AXIS, minor_axis) grid.

    The JAX module's constructor, with ranks for devices: when both
    factors are given and name fewer ranks than the world holds, the
    mesh takes the leading major*minor ranks (the others hold no
    coordinate in it, and warn); an inferred factor (major=None) spans
    every rank; asking for more ranks than exist is an error."""
    devices = list(devices if devices is not None else world_ranks())
    if minor < 1 or (major is not None and major < 1):
        raise ValueError(f"mesh factors must be >= 1: {major}x{minor}")
    if major is None:
        if len(devices) % minor != 0:
            raise ValueError(
                f"{len(devices)} devices do not factor into "
                f"{minor_axis}={minor}")
        major = len(devices) // minor
    return named_mesh((major, minor), (DATA_AXIS, minor_axis), devices)


def build_mesh(spec=None, devices=None):
    """Build a ("data", "model") DeviceMesh over the world's ranks (or
    ``devices``, a rank list)."""
    devices = list(devices if devices is not None else world_ranks())
    if spec is None:
        spec = default_spec(len(devices))
    return grid_mesh(devices, spec.data, spec.model, MODEL_AXIS)


def reshape_spec(n_devices, model_parallelism=1):
    """MeshSpec for a fleet that just lost hosts: keeps the model axis
    when it still divides the surviving device count, else falls back
    to a 1-D data mesh (the JAX module's rule)."""
    if n_devices < 1:
        raise ValueError(f"no devices to reshape onto: {n_devices}")
    if model_parallelism > 1 and n_devices % model_parallelism == 0:
        return MeshSpec(data=n_devices // model_parallelism,
                        model=model_parallelism)
    if model_parallelism > 1:
        log.warning(
            "model=%d does not divide %d surviving devices; "
            "falling back to a 1-D data mesh", model_parallelism,
            n_devices)
    return MeshSpec(data=n_devices, model=1)


HOST_AXES = ("host_x", "host_y", "host_z")


def host_grid_mesh(process_bounds, devices=None):
    """Mesh over a host grid: ("host_x", "host_y", "host_z", "chip").

    ``process_bounds`` is the (px, py, pz) grid of the plugin's
    TPU_PROCESS_BOUNDS contract: worker w occupies cell (w // (py*pz),
    (w // pz) % py, w % pz). The world's ranks are host-major (a
    host's local ranks are consecutive), so a plain reshape puts every
    host's local ranks on the "chip" axis."""
    devices = list(devices if devices is not None else world_ranks())
    px, py, pz = process_bounds
    n_proc = px * py * pz
    if n_proc < 1 or len(devices) % n_proc != 0:
        raise ValueError(
            f"{len(devices)} devices do not factor into a "
            f"{px}x{py}x{pz} host grid")
    return named_mesh((px, py, pz, len(devices) // n_proc),
                      HOST_AXES + ("chip",), devices)


def _granules(devices, num_granules, hosts=None):
    """Split ranks into DCN granules (hosts or slices).

    Groups by ``hosts`` (a granule key a rank, aligned with
    ``devices``) when it tells ranks apart; otherwise cuts even chunks
    in rank order, which is host-major under the usual launch order
    (and emulates a split for tests)."""
    if hosts is not None:
        hosts = list(hosts)
        if len(hosts) != len(devices):
            raise ValueError(f"{len(hosts)} host keys for "
                             f"{len(devices)} devices")
        if len(set(hosts)) > 1:
            groups = {}
            for d, h in zip(devices, hosts):
                groups.setdefault(h, []).append(d)
            granules = [groups[k] for k in sorted(groups)]
            if num_granules is not None and len(granules) != num_granules:
                raise ValueError(
                    f"found {len(granules)} host granules, expected "
                    f"{num_granules}")
            return granules
    if num_granules is None:
        raise ValueError(
            "single-granule device set: pass num_granules to emulate "
            "a DCN split")
    if len(devices) % num_granules != 0:
        raise ValueError(
            f"{len(devices)} devices do not split into "
            f"{num_granules} granules")
    per = len(devices) // num_granules
    return [devices[i * per:(i + 1) * per]
            for i in range(num_granules)]


def build_hybrid_mesh(model=1, num_granules=None, devices=None,
                      hosts=None):
    """("data", "model") mesh spanning DCN granules (hybrid ICI x DCN).

    The model axis stays inside one granule, so its collectives ride
    the fast links; the data axis is granule-major, so its all-reduce
    decomposes into reductions within granules plus one ring across
    them. ``hosts`` names each rank's granule (``_granules``); without
    it ``num_granules`` cuts the ranks into even, rank-ordered
    granules. The JAX module's errors."""
    devices = list(devices if devices is not None else world_ranks())
    granules = _granules(devices, num_granules, hosts)
    per = len(granules[0])
    if any(len(g) != per for g in granules):
        raise ValueError("granules are unevenly sized")
    if per % model != 0:
        raise ValueError(
            f"model={model} does not divide the {per} devices of a "
            f"granule; tensor parallelism cannot span DCN")
    flat = [d for granule in granules for d in granule]
    return grid_mesh(flat, None, model, MODEL_AXIS)


def mesh_shape(mesh):
    """{axis name: size} of a DeviceMesh (the JAX mesh's ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis):
    """The size of ``axis`` (1 for an axis the mesh does not have)."""
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis):
    """This rank's coordinate along ``axis`` (0 for a missing axis);
    raises for a rank the mesh does not hold."""
    if axis not in mesh.mesh_dim_names:
        return 0
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank holds no coordinate in the mesh")
    return coord[mesh.mesh_dim_names.index(axis)]


def axis_group(mesh, axis):
    """The process group of this rank's peers along ``axis``."""
    return mesh.get_group(axis)
