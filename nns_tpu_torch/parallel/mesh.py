"""Device meshes for the sharded paths. Counterpart of
``nns_tpu/parallel/mesh.py``.

The JAX package's parallel layer is single-controller: one process builds a
``jax.sharding.Mesh`` and ``shard_map`` fans the work out over it. The port
keeps that shape. A ``Mesh`` here is an ordered tuple of ``torch.device``s
and a shape (1-D, or 2-D ``(n_dp, n_shard)`` row-major; the number of axes
is all the sharded functions read, so the axes carry no names);
the sharded functions launch one shard's work per mesh point, each on its
own device, and merge on ``devices[0]``.

``make_mesh`` and ``best_mesh`` take distinct devices only, as JAX's do.
``Mesh.virtual`` repeats one device: a mesh that lists ``cuda:0`` four times
runs four shards, four local kernels and the real merge on one card, the
counterpart of the JAX tests' virtual CPU devices
(``--xla_force_host_platform_device_count``). It shows that the shard
arithmetic and the merges are right; it shows nothing about scaling.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` in row-major order over ``shape``."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if not 1 <= len(self.shape) <= 2:
            raise ValueError(f"a mesh is 1-D or 2-D, not of shape {self.shape}")
        if math.prod(self.shape) != len(self.devices) or min(self.shape) < 1:
            raise ValueError(f"{len(self.devices)} devices do not fill shape {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @classmethod
    def virtual(cls, shape: int | tuple[int, ...], device="cuda") -> "Mesh":
        """``device`` repeated over ``shape``: an int gives a 1-D mesh, a
        pair a 2-D ``(n_dp, n_shard)`` mesh."""
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return cls((dev,) * math.prod(shape), shape)


def _devices(device) -> list[torch.device]:
    """The distinct devices of ``device``'s type: every CUDA device, or the
    one CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device {device}")


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` distinct devices of
    ``device``'s type (default: all of them). Raises ValueError past them,
    and when there is none: a CUDA mesh never falls back to the CPU."""
    devices = _devices(device)
    if not devices:
        raise ValueError(f"no {torch.device(device).type} device: a mesh needs one at least")
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices):
        raise ValueError(f"requested {n_devices} {torch.device(device).type} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(devices[:n_devices]), (n_devices,))


def best_mesh(n: int, device="cuda") -> Mesh:
    """Mesh sized for sharding ``n`` reference points: every distinct
    device, up to one per point."""
    return make_mesh(max(1, min(len(_devices(device)), n)), device)
