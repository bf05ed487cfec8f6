"""Production mesh of the dry run: a cluster of H100 nodes.

A FUNCTION, not a module constant, so that importing this module builds no
process group.  ``make_production_mesh`` starts a *fake* process group
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing) of 256 ranks, or 512 with ``multi_pod``, and lays a
``DeviceMesh`` over it with the JAX package's axis names: ``("data",
"model")``, or ``("pod", "data", "model")``.  This is the counterpart of the
JAX package's 512 fake host devices.

Shape: ``model`` stays inside the NVLink domain of one 8-card node, so a
single pod is (data=32, model=8) and two are (pod=2, data=32, model=8).  The
JAX package's (16, 16) fits a TPU pod's torus; on H100s tensor parallelism
over 16 cards would cross the node's network on every layer.

The mesh's device type is ``"cpu"``: DTensor's cost model asks the device
type's module for a device count, which ``"meta"`` has not.  On a CPU mesh
DTensor turns a shard-to-shard redistribute into an all-gather and a chunk
(gloo has no all-to-all); the dry run's trace puts the all-to-all back
(``launch.dryrun``), so that it is priced as one.

The constants are one H100 SXM's and one DGX H100 node's, from NVIDIA's
data sheets, at the card's full 700 W; the roofline (``analysis.roofline``)
divides by them.  They are data-sheet figures, not measurements.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (no sparsity), 700 W
PEAK_FLOPS_BF16 = 989e12        # flop/s per card
# NVIDIA H100 SXM data sheet: HBM3 bandwidth of the 80 GB part
HBM_BW = 3.35e12                # bytes/s per card
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per card in both directions
NVLINK_BW = 450e9               # bytes/s per card, each way: the 'model' axis
# NVIDIA DGX H100 data sheet: eight ConnectX-7 400 Gb/s ports a node, one a card
NET_BW = 50e9                   # bytes/s per card, each way: 'data' and 'pod'
AXIS_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}

NODE_CARDS = 8                  # one DGX H100 node: the NVLink domain


# the meshes laid over the fake group now up, by (shape, axes): DTensor caches
# its redistribute plans by a mesh's shape and names, so a second mesh of the
# same form would meet the first one's process groups in them
_MESHES: dict = {}


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process group
    of ``prod(shape)`` ranks, this process rank 0; the same mesh again for the
    same form.  A fake group of another size is torn down first; a real one
    is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run's mesh needs the fake process group; a "
                               f"{dist.get_backend()} group is already initialised")
        if dist.get_world_size() != n:
            teardown_mesh()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", key[0], mesh_dim_names=key[1])
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 32, NODE_CARDS) if multi_pod else (32, NODE_CARDS)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def teardown_mesh() -> None:
    """Destroy the fake process group, if one is up (tests call it)."""
    import torch.distributed as dist
    _MESHES.clear()
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def dp_axes(mesh):
    """The pure-data-parallel axes of a mesh (everything except 'model')."""
    names = tuple(n for n in mesh.mesh_dim_names if n != "model")
    return names if len(names) > 1 else names[0]


def axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for name in names:
        n *= sizes[name]
    return n
