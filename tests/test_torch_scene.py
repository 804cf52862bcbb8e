"""pyrite_tpu_torch.scene and kernels_dense.build_pack against the JAX
package on the dense scenes, two DE scenes and two mesh scenes; the refusal
gate; the port's own copies of the host modules, and that it imports
nothing of the JAX package; the kernel build without nvcc."""

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
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["flagship", "prism", "tri_lamp", "many_materials"]
# distance-estimated shapes, which the JAX package keeps out of its dense pack
DE_SCENES = ["fractal", "julia"]
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
        fractal=chip_smoke.write_fractal_scene(directory, 32, 32, 4, 3),
        julia=chip_smoke.write_julia_scene(directory, 32, 32),
    )


@pytest.fixture(scope="module")
def built(paths):
    return {
        name: (jax_build(jax_load(paths[name])), torch_build(torch_load(paths[name]), "cpu"))
        for name in SCENES + DE_SCENES + MESHES
    }


@pytest.mark.parametrize("name", SCENES + DE_SCENES + MESHES)
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
    assert len(st.de_shapes) == len(sj.de_shapes) == (name in DE_SCENES)


@pytest.mark.parametrize("name", DE_SCENES)
def test_de_shapes_match(built, name):
    """The estimator dicts, bounds and materials as the JAX package builds
    them; the JAX package keeps these scenes out of its dense pack."""
    sj, st = built[name]
    assert sj.dense_pack is None and st.dense_pack["meta"]["n_de"] == 1
    for dj, dt in zip(sj.de_shapes, st.de_shapes):
        assert (dt.bounds_kind, dt.material_id) == (dj.bounds_kind, dj.material_id)
        np.testing.assert_array_equal(dt.bounds_a, dj.bounds_a)
        np.testing.assert_array_equal(dt.bounds_b, dj.bounds_b)
        assert dt.estimator.keys() == dj.estimator.keys()
        for key, value in dj.estimator.items():
            if value is None or isinstance(value, str):
                assert dt.estimator[key] == value, key
            else:
                np.testing.assert_array_equal(dt.estimator[key], value, err_msg=key)


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
    assert meta["n_prims"] == 0 and meta["n_de"] == 0 and sheet.shape == (len(meta) - 3, 128)
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
    """JAX's dense pack is None for both, and the port packs both:
    examples/fractal.lua, which JAX keeps out of its pack for its DE shape,
    with that one DE shape; the 162-triangle terrain (129 to 1024
    primitives, which JAX sweeps brute force in XLA) through the clustered
    wide BVH, above the dense kernels' 128 (scene.CLUSTER_THRESHOLD)."""
    path = (
        os.path.join(ROOT, "examples", "fractal.lua") if which == "fractal"
        else _terrain(tmp_path, 9)
    )
    assert jax_build(jax_load(path)).dense_pack is None
    scene = torch_build(torch_load(path), "cpu")
    if which == "fractal":
        assert scene.dense_pack["meta"]["n_de"] == 1 and len(scene.de_shapes) == 1
        return
    assert scene.num_primitives == 163 and scene.use_clusters
    assert scene.dense_pack["meta"]["n_prims"] == 0


def test_convert_round_trip(built):
    sj, _ = built["tri_lamp"]
    host = {k: np.asarray(v) for k, v in sj.arrays.items()}
    back = convert.scene_arrays_from_numpy(host, "cpu")
    for key, value in host.items():
        assert back[key].numpy().dtype == value.dtype
        np.testing.assert_array_equal(back[key].numpy(), value)
    acc = np.random.default_rng(0).uniform(size=(4, 8, 64)).astype(np.float32)
    a, w = convert.film_from_numpy(acc, acc * 2, "cpu")
    np.testing.assert_array_equal(a.numpy(), acc)
    np.testing.assert_array_equal(w.numpy(), acc * 2)


def test_port_imports_no_jax(tmp_path):
    """No module the port loads lies under pyrite_tpu/, and loading the
    project and building a mesh scene (which builds the native library)
    writes nothing there."""
    before = sorted(os.listdir(os.path.join(ROOT, "pyrite_tpu", "native")))
    scene = _terrain(tmp_path, 24)
    code = (
        "import os, sys, pyrite_tpu_torch, pyrite_tpu_torch.cli, pyrite_tpu_torch.bvh\n"
        "import pyrite_tpu_torch.kernels, pyrite_tpu_torch.kernels_dense, chip_smoke\n"
        "from pyrite_tpu_torch.project import load_project\n"
        "from pyrite_tpu_torch.scene import build_scene\n"
        f"assert build_scene(load_project({scene!r}), 'cpu').use_clusters\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "ref = os.path.join(os.getcwd(), 'pyrite_tpu') + os.sep\n"
        "files = [getattr(m, '__file__', None) or '' for m in list(sys.modules.values())]\n"
        "assert not [f for f in files if os.path.abspath(f).startswith(ref)], 'pyrite_tpu loaded'\n"
        "print(sorted(m for m in sys.modules if m.startswith('pyrite_tpu_torch.')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "pyrite_tpu_torch.project" in out.stdout and "pyrite_tpu_torch.native" in out.stdout
    assert "_shared" not in out.stdout
    assert not os.path.exists(os.path.join(ROOT, "pyrite_tpu_torch", "_shared"))
    assert sorted(os.listdir(os.path.join(ROOT, "pyrite_tpu", "native"))) == before


# The port's copies of the JAX package's host modules (lua/, project/,
# native/, data/), held to their originals line for line, except the lines
# the port changed: each listed here as (original line, port line).
COPIED = {
    "lua": ["__init__.py", "interpreter.py", "lexer.py", "parser.py", "patterns.py", "stdlib.py"],
    "project": ["__init__.py", "dsl.py", "ir.py", "load.py", "meshes.py", "textures.py"],
    "native": ["__init__.py", "scene_build.cpp"],
}
CHANGED_LINES = {
    "native/__init__.py": [
        # the library is built into the port's ignored _build/, not beside
        # its source
        ('_SO = os.path.join(_DIR, "libscene.so")',
         '_SO = os.path.join(os.path.dirname(_DIR), "_build", "libscene.so")'),
        (None, "            os.makedirs(os.path.dirname(_SO), exist_ok=True)"),
    ],
}


# Docstrings cite the Rust original's sources by their path inside its own
# tree (pyrite/src/...), without the original's checkout prefix.
CITATION = re.compile(r"[^\s(]*/(pyrite/src/)")


@pytest.mark.parametrize("rel", [f"{d}/{f}" for d, files in COPIED.items() for f in files])
def test_copied_host_module_matches_original(rel):
    import difflib

    with open(os.path.join(ROOT, "pyrite_tpu", rel)) as fh:
        original = [CITATION.sub(r"\1", line) for line in fh.read().splitlines()]
    with open(os.path.join(ROOT, "pyrite_tpu_torch", rel)) as fh:
        port = fh.read().splitlines()
    changes = []
    for op, i1, i2, j1, j2 in difflib.SequenceMatcher(None, original, port, autojunk=False).get_opcodes():
        if op == "equal":
            continue
        old, new = original[i1:i2], port[j1:j2]
        for k in range(max(len(old), len(new))):
            changes.append((old[k] if k < len(old) else None, new[k] if k < len(new) else None))
    assert changes == CHANGED_LINES.get(rel, [])


def test_copied_data_matches_original():
    with open(os.path.join(ROOT, "pyrite_tpu", "data", "colorimetry.npz"), "rb") as fh:
        original = fh.read()
    with open(os.path.join(ROOT, "pyrite_tpu_torch", "data", "colorimetry.npz"), "rb") as fh:
        assert fh.read() == original
    for directory, files in COPIED.items():
        sources = {f for f in os.listdir(os.path.join(ROOT, "pyrite_tpu", directory))
                   if f.endswith((".py", ".cpp"))}
        assert sources == set(files), directory


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
