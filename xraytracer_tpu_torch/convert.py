"""State carried across from the JAX package: scene tables and cameras.

The JAX package's ``SceneTables`` and ``PinholeCamera`` are tuples of
arrays; as numpy they are this port's tables and camera on a device. This
module imports neither package's counterpart — the caller converts:

    d = {k: np.asarray(v) for k, v in jax_tables._asdict().items()}
    tables = tables_from_numpy(d, device="cuda")
"""

import numpy as np
import torch

from .camera import PinholeCamera
from .device import resolve_device
from .scene.tables import SceneTables


def tables_from_numpy(d, device=None) -> SceneTables:
    """``{field: np.ndarray}`` with every ``SceneTables`` field -> tables on
    ``device``. Integer fields become int32, the rest float32."""
    device = resolve_device(device)
    missing = [k for k in SceneTables._fields if k not in d]
    extra = [k for k in d if k not in SceneTables._fields]
    if missing or extra:
        raise ValueError(
            f"scene table fields differ: missing {missing}, unknown {extra}"
        )
    out = {}
    for k in SceneTables._fields:
        a = np.asarray(d[k])
        a = a.astype(np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32)
        out[k] = torch.as_tensor(np.ascontiguousarray(a)).to(device)
    return SceneTables(**out)


def tables_to_numpy(tables: SceneTables) -> dict:
    """Tables -> ``{field: np.ndarray}`` on the host."""
    return {k: v.detach().cpu().numpy() for k, v in tables._asdict().items()}


def camera_from_numpy(c2w, scale, aspect, device=None) -> PinholeCamera:
    """A JAX ``PinholeCamera``'s three leaves as numpy -> this port's camera
    on ``device`` (``scale`` is tan(fov/2) as the JAX package stored it)."""
    device = resolve_device(device)
    f32 = torch.float32
    return PinholeCamera(
        c2w=torch.from_numpy(np.array(c2w, np.float32)).to(device),
        scale=torch.tensor(float(scale), dtype=f32, device=device),
        aspect=torch.tensor(float(aspect), dtype=f32, device=device),
    )
