"""Meshes (the port of ``repro.launch.mesh``).

Functions, not module constants: importing this module creates no process
group.

- ``make_production_mesh``: single pod (16, 16) over ("data", "model"), 256
  devices; multi-pod (2, 16, 16) over ("pod", "data", "model"), 512. They
  are built on PyTorch's fake process group (``FakeStore``), on which a
  ``DeviceMesh`` of any size exists in one process and every collective is
  a no-op: the dry run reads their shapes and shardings, nothing runs on
  them.
- ``make_host_mesh``: this host's devices as (n, 1) over ("data",
  "model"): the card by default, the CPU on request. It makes a one-process
  group if none exists.

A process has one default group: a fake one and a real one cannot both be
it. ``make_production_mesh`` replaces a fake group of another size and
refuses a real one; ``make_host_mesh`` refuses a fake one. So the dry run
runs in its own process (``python -m repro_torch.launch.dryrun``), and a
test that builds a production mesh tears its group down
(``destroy_group``).
"""

from __future__ import annotations

import torch.distributed as dist

from repro_torch import resolve_device


def _group_backend() -> str | None:
    if not dist.is_initialized():
        return None
    return dist.get_backend()


def destroy_group() -> None:
    """Tear down the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 1
    for n in shape:
        size *= n
    backend = _group_backend()
    if backend is not None and backend != "fake":
        raise RuntimeError(
            f"a {backend!r} process group is this process's default group: "
            "the production meshes need the fake one (run the dry run in its "
            "own process)")
    if backend == "fake" and dist.get_world_size() != size:
        destroy_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=size)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """This host's devices as (n, 1) over ("data", "model"): one CUDA card
    (``device`` None or a CUDA device; n = 1, one process drives one card)
    or the CPU (``device="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = _group_backend()
    if backend == "fake":
        raise RuntimeError("the fake process group of a production mesh is "
                           "this process's default group; tear it down "
                           "(mesh.destroy_group) before making a host mesh")
    if backend is None:
        # one process: a store in memory, no address to reach
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (n, 1),
                            mesh_dim_names=("data", "model"))
