"""xraytracer_tpu_torch — the PyTorch/CUDA port of ``xraytracer_tpu``.

A second package beside the JAX one, module for module (same tree, same
names), for one NVIDIA H100: plain tensor code is PyTorch, and what the JAX
package wrote as Pallas kernels (the triangle sweeps, the whole-path surface
and homogeneous-volume kernels, the heterogeneous tracking kernels, the
analytic surface-gradient kernel) are CUDA kernels written for Hopper (``csrc/``, built with nvcc at first use, see
``_build.py``).
It imports ``torch`` and ``numpy``, never ``jax`` and nothing of the JAX
package. Entry points run on the card unless the caller passes
``device="cpu"``.

Everything the JAX package does but its TPU-only mechanisms:
  math/         vector/matrix/optics math
  sampling/     counter-based RNG (bitwise equal to the JAX package's),
                warps, discrete distributions
  geometry/     ray/hit records, batched intersection, kernel wrappers,
                bounce-ray coherence sorting (raysort.py)
  scene/        flat scene tables, builder, Cornell preset
  materials.py  BSDF tables (Lambert/Mirror/Glass)
  lights.py     area light tables
  media.py      homogeneous and heterogeneous media (delta / ratio tracking)
  media_kernels.py  the tracking kernels' wrappers and plain versions
  integrators/  Normal, Indirect/GI path tracing (NEE, MIS, stats), the
                whole-path surface kernels, volume path tracing (VPT,
                VPT-NEE) and the whole-path homogeneous volume kernels
  renderer.py   spp-chunked wavefront execution, checkpoints, the pixel
                split over a process group (sharding=)
  parallel/     torch.distributed process groups: pixel and spp splits
  diff.py       gradients w.r.t. albedo, emission and density: autograd
                through the wavefront integrators, and the analytic
                forward-pass kernels, on one device or over a group
  tools/        fit_scene.py / fit_volume.py (inverse rendering), vdb.py,
                grid_convert.py, majorant_stats.py
  film.py, config.py, cli.py, convert.py
"""

__version__ = "0.1.0"

from . import constants
from . import math  # noqa: F401
from . import sampling  # noqa: F401
from . import geometry  # noqa: F401
from . import scene  # noqa: F401
from . import materials  # noqa: F401
from . import lights  # noqa: F401
from . import media  # noqa: F401
from . import integrators  # noqa: F401
from . import renderer  # noqa: F401
from . import diff  # noqa: F401
from .camera import PinholeCamera
from .film import write_image

__all__ = [
    "constants", "math", "sampling", "geometry", "scene", "materials",
    "lights", "media", "integrators", "renderer", "diff", "PinholeCamera",
    "write_image", "__version__",
]
