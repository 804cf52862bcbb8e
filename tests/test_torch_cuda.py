"""The CUDA kernels against their plain PyTorch version on the card (the
kernels have no CPU mode, so this skips without a CUDA device).

The module imports neither JAX nor the JAX package, so it runs on a machine
without them: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(tests/conftest.py configures JAX)."""

import pytest
import torch

import chip_smoke
from pyrite_tpu_torch import kernels

torch.set_num_threads(2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "prism", "tri_lamp", "many_materials"])
def test_cuda_kernels_match_plain_version(tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    paths = chip_smoke.scene_paths(str(tmp_path), width=128, height=64, spectrum_samples=6, bounces=8)
    worst = chip_smoke.check_kernels(name, paths[name], lanes=8192)
    assert worst["divergent"] < 0.015


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["terrain_24", "tri_lamp_24", "terrain_405"])
def test_cuda_wide_kernels_match_plain_version(tmp_path, name):
    """The mesh-scene kernels: the traversal queries (t, kind, idx, u and v
    bit-equal on every lane) and the wide bounce and NEE kernels against
    tracer.bounce_core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    directory = str(tmp_path)
    if name == "tri_lamp_24":
        path = chip_smoke.write_tri_lamp_scene(directory, width=128, height=64, cells=24)
    else:
        cells = int(name.split("_")[1])
        path = chip_smoke.terrain_paths(directory, cells=(cells,), width=128, height=64)[name]
    chip_smoke.check_queries(name, path, lanes=8192)
    worst = chip_smoke.check_kernels(name, path, lanes=8192)
    assert worst["divergent"] < 0.015


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fractal", "julia", "terrain_de_24"])
def test_cuda_de_kernels_match_plain_version(tmp_path, name):
    """The DE march kernel against tracer.march_de_plain (hit flags on
    >= 99.9 % of lanes, t to rtol 1e-5), and the bounce and NEE kernels,
    which march DE shapes after the primitives (dense or wide), against
    tracer.bounce_core."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    directory = str(tmp_path)
    if name == "fractal":
        path = chip_smoke.write_fractal_scene(directory, 128, 64, 4, 3)
    elif name == "julia":
        path = chip_smoke.write_julia_scene(directory, 128, 64)
    else:
        path = chip_smoke.write_terrain_de_scene(directory, width=128, height=64)
    marched = chip_smoke.check_march(name, path, lanes=8192)
    assert marched["flags_differ"] <= 8
    worst = chip_smoke.check_kernels(name, path, lanes=8192)
    assert worst["divergent"] < 0.015


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [24, 405])
@pytest.mark.parametrize("cut, idle", [(8191, 0.0), (8192, 0.5)], ids=["8191_rays", "half_idle"])
def test_cuda_wide_kernels_with_idle_threads(tmp_path, cells, cut, idle):
    """Every thread of a warp takes part in the warp's leaf sweeps: a
    wavefront whose last warp is partial (8,191 rays), and a random half of
    the lanes dead (the running hit at t = 0 for the queries) or without
    NEE. The queries stay bit-equal to the plain version on every lane, the
    wide bounce and NEE kernels held to tracer.bounce_core as phase 3 holds
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    name = f"terrain_{cells}"
    path = chip_smoke.terrain_paths(str(tmp_path), cells=(cells,), width=128, height=64)[name]
    chip_smoke.check_queries(name, path, lanes=8192, cut=cut, idle=idle)
    worst = chip_smoke.check_kernels(name, path, lanes=8192, cut=cut, idle=idle)
    assert worst["divergent"] < 0.015


@pytest.mark.cuda
def test_cuda_traversal_refuses_misaligned_leaves(tmp_path):
    """The traversal reads clu_geo's rows as 16-byte loads: a leaf table
    that is not 16-byte aligned is refused before the launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.terrain_paths(str(tmp_path), cells=(24,), width=32, height=16)["terrain_24"]
    scene = chip_smoke.load_scene(path)[0]
    geo = scene.arrays["clu_geo"]
    shifted = torch.empty(geo.numel() + 1, device="cuda")[1:].view(geo.shape)
    shifted.copy_(geo)
    scene.arrays["clu_geo"] = shifted
    o = torch.zeros((32, 3), device="cuda")
    d = torch.ones((32, 3), device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        kernels.closest_wide(scene, o, d)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.shadow_wide(scene, o, d, torch.ones(32, device="cuda"), torch.ones(32, device="cuda"))
