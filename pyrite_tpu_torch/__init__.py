"""pyrite-tpu on PyTorch and CUDA: the spectral path tracer's port to Hopper.

The JAX package ``pyrite_tpu`` stays the reference; this package holds the
PyTorch counterparts of its modules under the same names, and hand-written
CUDA kernels (``csrc/``) for the kernels the JAX package wrote in Pallas. It
never imports JAX nor anything of ``pyrite_tpu``: the host code it needs
(the Lua interpreter ``lua/``, the project loader ``project/``, the native
SAH builder and OBJ parser ``native/`` and the colorimetry tables ``data/``)
is its own copy, held line for line to the original by a test.
"""

import torch as _torch

# Mirrors pyrite_tpu/__init__.py, which forces f32 matmuls: camera transforms
# and the colorimetric integration lose visible precision in TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
