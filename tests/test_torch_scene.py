"""pyrite_tpu_torch.scene and kernels_dense.build_pack against the JAX
package on the dense scenes and two mesh scenes; the refusal gate; the
jax-free import bridge; the kernel build without nvcc."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.scene import build_scene as jax_build
from pyrite_tpu_torch import _build, convert, kernels_dense
from pyrite_tpu_torch._shared.project import load_project as torch_load
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["flagship", "prism", "tri_lamp", "many_materials"]
MESHES = ["terrain_24", "tri_lamp_24"]
# the JAX package's padded and channel-major copies for its TPU kernels
TPU_COPIES = {"wide_rows_pad", "clu_geo_ch"}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("scenes"))
    return dict(
        chip_smoke.scene_paths(directory),
        **chip_smoke.terrain_paths(directory, cells=(24,), width=32, height=16),
        tri_lamp_24=chip_smoke.write_tri_lamp_scene(directory, cells=24),
    )


@pytest.fixture(scope="module")
def built(paths):
    return {
        name: (jax_build(jax_load(paths[name])), torch_build(torch_load(paths[name])))
        for name in SCENES + MESHES
    }


@pytest.mark.parametrize("name", SCENES + MESHES)
def test_scene_arrays_match(built, name):
    sj, st = built[name]
    assert set(st.arrays) == set(sj.arrays) - TPU_COPIES
    assert st.use_clusters == sj.use_clusters == (name in MESHES)
    for key, value in sj.arrays.items():
        if key in TPU_COPIES:
            continue
        want = np.asarray(value)
        got = st.arrays[key].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    for attr in ("num_planes", "num_triangles", "num_spheres", "num_lamps", "lamp_types"):
        assert getattr(st, attr) == getattr(sj, attr), attr


@pytest.mark.parametrize("name", SCENES)
def test_pack_sheet_matches(built, name):
    sj, st = built[name]
    assert sj.dense_pack is not None
    np.testing.assert_array_equal(st.dense_pack["sheet"], np.asarray(sj.dense_pack["sheet"]))
    meta = st.dense_pack["meta"]
    assert all(meta[k] == v for k, v in sj.dense_pack["meta"].items() if k in meta)


@pytest.mark.parametrize("name", MESHES)
def test_mesh_pack(built, name):
    """A mesh scene's sheet: no primitive rows; the other tables as on a
    dense scene; each lamp's own sphere or triangle in the lamp rows."""
    _, st = built[name]
    pack = st.dense_pack
    meta, sheet = pack["meta"], pack["sheet"]
    assert meta["n_prims"] == 0 and sheet.shape == (len(meta) - 2, 128)
    a = {k: v.numpy() for k, v in st.arrays.items()}
    np.testing.assert_array_equal(sheet[meta["comp_bsdf"], : len(a["comp_bsdf"])], a["comp_bsdf"])
    ref = a["lamp_ref"]
    n = st.num_lamps
    np.testing.assert_array_equal(sheet[meta["lamp_ref"], :n], np.arange(n))
    if name == "tri_lamp_24":
        assert st.lamp_types == {3} and n == 2
        for axis, c in enumerate("xyz"):
            np.testing.assert_array_equal(sheet[meta[f"ltri_v0{c}"], :n], a["tri_v0"][ref, axis])
            np.testing.assert_array_equal(sheet[meta[f"ltri_n2{c}"], :n], a["tri_n"][ref, 2, axis])
        np.testing.assert_array_equal(sheet[meta["ltri_mat"], :n], a["tri_mat"][ref])
    else:
        assert st.lamp_types == {2} and n == 1
        np.testing.assert_array_equal(sheet[meta["lsph_r"], :n], a["sph_radius"][ref])
        np.testing.assert_array_equal(sheet[meta["lsph_cy"], :n], a["sph_center"][ref, 1])


def test_scene_shapes_are_covered(built):
    """Between them the scenes reach every branch of both kernels and the
    program bank tables."""
    flag, prism, tri, many = (built[n][1] for n in SCENES)
    assert flag.lamp_types == {2} and flag.num_spheres == 4
    assert len(flag.prob_programs) == 2 and all(p.uses_ray_inputs for p in flag.prob_programs)
    assert prism.num_planes == 1 and prism.lamp_types == {1}
    assert tri.lamp_types == {3} and tri.num_triangles == 52
    assert many.color_bank_bakeable is not None and "color_bank" in many.arrays


def _terrain(directory, cells):
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_scene

    return terrain_scene(str(directory), cells=cells, width=32, height=16)[0]


@pytest.mark.parametrize("which", ["fractal", "terrain_162"])
def test_refuses_exactly_where_jax_pack_is_none(tmp_path, which):
    path = (
        os.path.join(ROOT, "examples", "fractal.lua") if which == "fractal"
        else _terrain(tmp_path, 9)
    )
    assert jax_build(jax_load(path)).dense_pack is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch_build(torch_load(path))


def test_convert_round_trip(built):
    sj, _ = built["tri_lamp"]
    host = {k: np.asarray(v) for k, v in sj.arrays.items()}
    back = convert.scene_arrays_from_numpy(host)
    for key, value in host.items():
        assert back[key].numpy().dtype == value.dtype
        np.testing.assert_array_equal(back[key].numpy(), value)
    acc = np.random.default_rng(0).uniform(size=(4, 8, 64)).astype(np.float32)
    a, w = convert.film_from_numpy(acc, acc * 2)
    np.testing.assert_array_equal(a.numpy(), acc)
    np.testing.assert_array_equal(w.numpy(), acc * 2)


def test_port_imports_no_jax():
    code = (
        "import sys, pyrite_tpu_torch, pyrite_tpu_torch.cli, pyrite_tpu_torch.bvh\n"
        "import pyrite_tpu_torch.kernels, pyrite_tpu_torch.kernels_dense\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m == 'pyrite_tpu' or m.startswith('pyrite_tpu.') for m in sys.modules)\n"
        "shared = {m.split('.')[2] for m in sys.modules if m.startswith('pyrite_tpu_torch._shared.')}\n"
        "assert shared <= {'lua', 'project', 'native'}, shared\n"
        "print(sorted(shared))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "project" in out.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_meta_fields_match_kernel_enum():
    with open(os.path.join(_build.CSRC, "common.cuh")) as fh:
        src = fh.read()
    body = re.search(r"enum Meta \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "M_COUNT"
    assert [n[2:].lower() for n in names[:-1]] == list(kernels_dense.META_FIELDS)
