"""Carry the JAX package's scene tables, random draws and film buffers into
the port, taken as numpy arrays: the tests use these to feed both packages
the same inputs. Dtypes are kept (float32, int32, bool); the draws' lamp
indices become int32, the type the CUDA kernels take. Each helper puts its
tensors on the card unless the caller asks for the CPU (device="cpu"), and
raises on a CUDA device without one."""

from __future__ import annotations

import numpy as np
import torch

from .scene import require_device


def _tensor(x, device):
    # a copy: arrays taken from JAX are read-only views of its buffers
    return torch.as_tensor(np.array(x, order="C"), device=require_device(device, "convert"))


def scene_arrays_from_numpy(arrays: dict, device="cuda") -> dict:
    """``scene.arrays`` of either package, as numpy, -> the port's tensors."""
    return {k: _tensor(v, device) for k, v in arrays.items()}


def draws_from_numpy(draws: dict, device="cuda") -> dict:
    """One bounce's draws (tracer.draw_bounce_uniforms' dict) -> tensors."""
    out = {k: _tensor(np.asarray(v, np.float32), device) for k, v in draws.items() if k != "lamp_idx"}
    if "lamp_idx" in draws:
        out["lamp_idx"] = _tensor(np.asarray(draws["lamp_idx"], np.int32), device)
    return out


def film_from_numpy(acc, wt, device="cuda"):
    """Film buffers [H, W, BINS] -> (acc, wt) float32 tensors."""
    return (
        _tensor(np.asarray(acc, np.float32), device),
        _tensor(np.asarray(wt, np.float32), device),
    )


def textures_from_numpy(store: dict, scene, device="cuda") -> None:
    """The JAX scene's texture store (its Resources.store: key -> [H, W, 4]
    or [H, W] array) into the port scene's: its Resources store, which the
    plain programs read, and the texture table the kernels read
    (scene.dense_pack). The keys and shapes must be the port's own."""
    dev = require_device(device, "convert")
    resources = scene.resources
    for key, data in store.items():
        if key not in resources.store or np.shape(data) != np.shape(resources.store[key]):
            raise ValueError(f"texture {key!r}: not the port scene's, or of another shape")
        resources.store[key] = np.array(data, np.float32, order="C")
    resources.tensors.clear()
    textures = scene.dense_pack["programs"].tables(dev)
    if textures:
        scene.dense_pack["tensors"]["tex"] = torch.cat([t.reshape(-1) for t in textures])
