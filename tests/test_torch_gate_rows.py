"""Tables past 128 rows, more than 16 spectrum samples and long programs in
the port, held to the JAX package on the CPU.

- Tables: a table of n entries takes ceil(n / 128) consecutive sheet rows
  (kernels_dense.build_pack). tables_129 is the flagship with 129 point
  lamps, 129 planes (the last a wall behind the scene, which camera rays
  hit) and 70 balls of a mirror-diffuse mix each (145 components);
  materials_300 (chip_smoke.write_spheres_scene) has 300 spheres of a
  diffuse colour of their own, 150 of them mixed with an emissive colour
  (150 lamps and emissive components), and 130 floors: the wide BVH, and a
  colour table that the scene bakes (scene.bake_bank_tables), which the
  port reads by tracer._bank_table_eval as the JAX package's
  eval_color_bank does.
- S = 24 and 64 through bounce_core, a mesh at S = 32 (terrain_24), a DE
  scene at S = 24 (the julia scene) and the flagship at S = 24 with four
  light samples (the JAX default), whose NEE adds pin the order of the
  light samples' terms per lane: the plain version that the gate form's
  streamed kernels (past 16 columns) are held to on the card.
- A colour program of 82 instructions at stack depth 12
  (chip_smoke.DEEP): its lane and column code against its one stream, bit
  for bit, and against the JAX package's program.
- The CLI from .lua to PNG under each scheduler and the bidirectional
  renderer at S = 24, and the scenes the gate refused before.

Tolerances: bounce_core per lane as tests/test_torch_kernels_dense.py's
(flags exact, vectors rtol 1e-3 / atol 1e-4, brightness with < 1.5 %
divergent lanes, energy within 0.5 %); the colour table rtol 1e-6 / atol
1e-7 (the same lerp of the same table); programs against JAX rtol 1e-5 /
atol 1e-6."""

import functools
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import chip_smoke
import pyrite_tpu.tracer as JT
from pyrite_tpu.exprs import ProgramInputs as JaxInputs
from pyrite_tpu.film import Film as JaxFilm
from pyrite_tpu.project import load_project as jax_load
from pyrite_tpu.renderers.simple import chunk_rays as jax_chunk_rays
from pyrite_tpu.scene import CameraModel as JaxCamera, build_scene as jax_build
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import cli, convert, exprs, kernels_dense as kd
from pyrite_tpu_torch.exprs import ProgramInputs
from pyrite_tpu_torch.project import load_project as torch_load
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.scene import build_scene as torch_build

torch.set_num_threads(2)

LANES = 512


def _tables_objects():
    """The Lua objects tables_129 adds to the flagship."""
    lamps = [f"light.point {{position = vector({(k % 13 - 6) * 0.8:.1f}, 9, {k // 13 * 0.8 + 6:.1f}), "
             f"color = light_source.d65 * 0.4}}," for k in range(129)]
    planes = [f"shape.plane {{origin = vector(0, {1.0 + 0.01 * k:.2f}, 0), normal = vector(0, 1, 0), "
              f"material = {{surface = material.diffuse {{color = 0.5}}}}}}," for k in range(128)]
    planes.append("shape.plane {origin = vector(0, 0, -30), normal = vector(0, 0, -1), "
                  "material = {surface = material.diffuse {color = rgb(0.3, 0.5, 0.7)}}},")
    balls = [f"shape.sphere {{radius = 0.2, position = vector({(k % 10 - 4.5) * 0.5:.2f}, 0.2, "
             f"{k // 10 * 0.5 + 4:.2f}), material = {{surface = mix(material.mirror {{color = 0.9}}, "
             f"material.diffuse {{color = rgb({0.1 + k / 80:.3f}, 0.5, {0.9 - k / 80:.3f})}}, 0.5)}}}},"
             for k in range(70)]
    return lamps + planes + balls


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("rows"))
    flagship = chip_smoke.scene_paths(directory, 64, 32, 4, 4)["flagship"]
    s24 = [("spectrum_samples = 4", "spectrum_samples = 24"), ("pixel_samples = 256",
                                                               "pixel_samples = 2")]
    materials_129 = [
        f"shape.sphere {{radius = 0.1, position = vector({k}, 30, 30), material = {{surface = "
        f"material.diffuse {{color = {0.001 * k:.3f}}}}}}}," for k in range(129)]
    julia = os.path.join(directory, "julia_s24")
    os.makedirs(julia)
    terrain = chip_smoke.terrain_paths(directory, cells=(24,), width=64, height=32)["terrain_24"]
    return {
        "tables_129": chip_smoke.add_objects(flagship, _tables_objects(), "tables_129"),
        "flagship_s64": chip_smoke.add_objects(flagship, [], "flagship_s64", [
            ("spectrum_samples = 4", "spectrum_samples = 64"), s24[1]]),
        "flagship_s24_ls4": chip_smoke.add_objects(flagship, [], "flagship_s24_ls4", s24 + [
            ("light_samples = 2", "light_samples = 4")]),
        "terrain_24_s32": chip_smoke.add_objects(terrain, [], "terrain_24_s32", [
            ("spectrum_samples = 4,", "spectrum_samples = 32,")]),
        "julia_s24": chip_smoke.write_julia_scene(julia, 64, 32, spectrum_samples=24),
        "materials_300": chip_smoke.write_spheres_scene(directory, 300, 64, 32, distinct=True,
                                                        emissive=150, planes=130),
        "materials_129": chip_smoke.add_objects(
            flagship, materials_129, "materials_129",
            [("image = {width = 64, height = 32}", "image = {width = 16, height = 8}")]),
        "flagship_s24": chip_smoke.add_objects(flagship, [], "flagship_s24", s24),
        "flagship_s24_bdpt": chip_smoke.add_objects(
            flagship, [], "flagship_s24_bdpt",
            s24 + [("renderer.simple {", "renderer.bidirectional {\n        light_bounces = 3,")]),
        "textures_deep": chip_smoke.write_textures_scene(directory, 24, 16, 4, 3, spp=2, deep=True),
    }


@functools.lru_cache(maxsize=None)
def _scenes(path):
    """(JAX project, JAX scene, port scene) of ``path``, built once: the
    tests of one scene share them."""
    pj = jax_load(path)
    return pj, jax_build(pj), torch_build(torch_load(path), "cpu")


def _setup(path, key):
    """Both packages' scenes and configs, and the same primary rays from the
    middle rows of the film."""
    pj, sj, st = _scenes(path)
    r, im = pj.project.renderer, pj.project.image
    cfg_j = JT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    cfg_t = TT.TraceConfig(r.bounces, r.light_samples, r.spectrum_samples)
    rows = max(1, LANES // im.width)
    film = JaxFilm(im.width, im.height, r.spectrum_bins, r.spectrum_span)
    _, oj, dj, wj = jax_chunk_rays(film, JaxCamera.from_ir(pj.project.camera), cfg_j, key,
                                   row0=(im.height - rows) // 2, rows=rows)
    return sj, st, cfg_j, cfg_t, (oj, dj, wj)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_tables_take_consecutive_rows(paths):
    """tables_129's pack: each table of n entries fills ceil(n / 128)
    consecutive rows, in order (entry i at row meta + i // 128, column i %
    128), and the gate takes it (it refused more than 128 before)."""
    st = _scenes(paths["tables_129"])[2]
    pack, a = st.dense_pack, {k: v.numpy() for k, v in st.arrays.items()}
    meta, flat = pack["meta"], pack["sheet"].reshape(-1)
    assert st.num_lamps == 130 and st.num_planes == 129 and not st.use_clusters
    assert a["comp_bsdf"].shape[0] > 128 and st.color_bank_bakeable is not None
    for field, values in (("lamp_vx", a["lamp_vec"][:, 0]), ("lamp_type", a["lamp_type"]),
                          ("pla_d", a["pla_d"]), ("pla_mat", a["pla_mat"]),
                          ("comp_bsdf", a["comp_bsdf"]), ("comp_color", a["comp_color"]),
                          ("mat_comp_offset", a["mat_comp_offset"])):
        n = len(values)
        start = meta[field] * kd.SHEET_WIDTH
        np.testing.assert_array_equal(flat[start:start + n], values.astype(np.float32), err_msg=field)
        rows = -(-n // kd.SHEET_WIDTH)
        nxt = min((r for r in meta.values() if r > meta[field]), default=len(pack["sheet"]))
        assert nxt - meta[field] == rows, field


# each scene's spectral columns and light samples
WIDTHS = {"tables_129": (4, 2), "materials_300": (4, 1), "flagship_s24": (24, 2),
          "flagship_s64": (64, 2), "terrain_24_s32": (32, 1), "julia_s24": (24, 1),
          "flagship_s24_ls4": (24, 4)}


@pytest.mark.parametrize("name", list(WIDTHS))
def test_bounce_core_matches_jax(paths, name):
    """tracer.bounce_core per lane against the JAX package's for two bounces
    from the camera, fed the JAX draws (each from the JAX state): lamp
    picks and planes past index 127, the baked colour table on the wide
    path, 24 and 64 spectral columns, a mesh at 32, a DE scene at 24 and
    four light samples at 24. The JAX bounce runs eagerly, and jitted
    where the JAX package walks clusters (past 1024 primitives;
    tests/test_torch_kernels_dense.py says why)."""
    sj, st, cfg_j, cfg_t, (oj, dj, wj) = _setup(paths[name], jax.random.PRNGKey(11))
    n, s = wj.shape
    if name == "tables_129":  # the back wall is the 129th plane
        hit = TT.intersect_scene(st, torch.as_tensor(np.array(oj)), torch.as_tensor(np.array(dj)))
        assert bool(((hit["kind"] == TT.KIND_PLANE) & (hit["idx"] >= 128)).any())
    assert (s, cfg_t.light_samples) == WIDTHS[name]
    assert st.use_clusters == (name in ("materials_300", "terrain_24_s32"))
    assert bool(st.de_shapes) == (name == "julia_s24")
    draw = jax.jit(lambda k: JT.draw_bounce_uniforms(sj, cfg_j, k, n))
    ref = {
        "origin": oj, "direction": dj,
        "brightness": jnp.zeros((n, s)), "reflectance": jnp.ones((n, s)),
        "alive": jnp.ones(n, bool), "aux_alive": jnp.ones(n, bool),
        "sample_light": jnp.ones(n, bool), "light_events": jnp.zeros(n, jnp.int32),
    }
    jax_bounce = lambda st_, k: JT.bounce_core(sj, cfg_j, wj, st_, k)[0]  # noqa: E731
    if sj.use_clusters:
        jax_bounce = jax.jit(jax_bounce)
    wl = torch.as_tensor(np.array(wj))
    for b in range(2):
        key = jax.random.fold_in(jax.random.PRNGKey(5), b)
        draws = convert.draws_from_numpy(_np(draw(key)), "cpu")
        state = {k: torch.as_tensor(np.array(v)) for k, v in ref.items()}
        # A DE hit's normal is a central difference of the estimator at eps
        # = DIST_EPSILON, which turns the packages' last-ulp estimator
        # differences into ~1e-3 of the normal: the direction a DE hit
        # scatters into is held to 1e-2, every other value per lane as below.
        de_hit = (TT.intersect_scene(st, state["origin"], state["direction"])["kind"]
                  == TT.KIND_DE).numpy() & np.asarray(ref["alive"])
        got = {k: v.numpy() for k, v in TT.bounce_core(st, cfg_t, wl, state, draws).items()}
        ref = jax_bounce(ref, key)
        want = _np(ref)
        for k in ("alive", "aux_alive", "sample_light", "light_events"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {b}: {k}")
        for k in ("origin", "direction", "reflectance"):
            lanes = ~de_hit if k == "direction" else slice(None)
            np.testing.assert_allclose(got[k][lanes], want[k][lanes], rtol=1e-3, atol=1e-4,
                                       err_msg=f"{name} {b}: {k}")
        np.testing.assert_allclose(got["direction"][de_hit], want["direction"][de_hit], atol=1e-2)
        assert de_hit.any() == (name == "julia_s24")
        rb, kb = want["brightness"], got["brightness"]
        assert (np.abs(rb - kb) > 1e-4 + 1e-3 * np.abs(rb)).any(axis=1).mean() < 0.015
        assert abs(rb.sum() - kb.sum()) < 0.005 * max(rb.sum(), 1e-6) + 1e-3
    assert float(np.asarray(ref["brightness"]).sum()) > 0


def test_color_table_matches_jax(paths):
    """materials_300's colour programs: baked in both packages, and the
    port's table read (tracer.eval_color_bank by _bank_table_eval) equals
    the JAX package's eval_color_bank at random wavelengths and programs,
    those of the 300 spheres, 150 emissive colours and 130 floors among
    them; precompute_bank_values keeps no per-launch
    [Pc, N, S] bank of them (the kernels read the table)."""
    _, sj, st = _scenes(paths["materials_300"])
    assert st.use_clusters and len(st.color_programs) == len(sj.color_programs) > 450
    assert st.color_bank_bakeable is not None and sj.color_bank_bakeable is not None
    np.testing.assert_allclose(st.arrays["color_bank"].numpy(), np.asarray(sj.arrays["color_bank"]),
                               rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(9)
    n, s = 4096, 6
    wl = rng.uniform(370.0, 790.0, (n, s)).astype(np.float32)
    prog = rng.integers(-1, 451, n).astype(np.int32)
    want = JT.eval_color_bank(sj, jnp.asarray(prog), JaxInputs(wavelength=jnp.asarray(wl)))
    got = TT.eval_color_bank(st, torch.as_tensor(prog).long(), ProgramInputs(torch.as_tensor(wl)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    bank = kd.precompute_bank_values(st, torch.as_tensor(wl))
    assert bank[0].shape == (0, n, s) and bank[2].shape == (1, n, s)


def test_long_program_split_equals_one_stream_and_jax(paths):
    """textures_deep's deep colour program (82 instructions, stack depth 12,
    past the old form's 64 and 8): the scene takes the kProg kernels with a
    stack of 12 values; its lane and column code give its one stream's value
    bit for bit at every column, and the JAX package's program at rtol 1e-5
    / atol 1e-6."""
    path = paths["textures_deep"]
    st, sj = torch_build(torch_load(path), "cpu"), jax_build(jax_load(path))
    kp = st.dense_pack["programs"]
    deep = [g for g in range(len(kp.off) - 1) if len(kp.program_code(g)) > 64]
    assert len(deep) == 1 and st.dense_pack["prog"]
    g = deep[0]
    assert exprs._depth(kp.program_code(g)) == 12 == kp.stack_depth == st.dense_pack["stack"]
    n, s = 256, 4
    rng = np.random.default_rng(4)
    wl = np.sort(rng.uniform(380.0, 780.0, (n, s)), axis=1).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    incident = rng.normal(size=(n, 3)).astype(np.float32)
    incident /= np.linalg.norm(incident, axis=1, keepdims=True)
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    T = torch.as_tensor
    args = (torch.arange(n), n, s, kp.leaf_values(T(wl)), kp.tables("cpu"))
    ray = {"normal": T(normal), "incident": T(incident), "uv": T(uv)}
    p = g - kp.counts[0]  # the colour program's number
    want = np.asarray(sj.color_programs[p](JaxInputs(
        wavelength=jnp.asarray(wl), normal=jnp.asarray(normal), incident=jnp.asarray(incident),
        uv=jnp.asarray(uv))))
    for k in range(s):
        split = kp.run(g, k, *args, **ray).numpy()
        np.testing.assert_array_equal(split, kp.run(g, k, *args, **ray, split=False).numpy())
        np.testing.assert_allclose(split[:, 0], np.broadcast_to(want, (n, s))[:, k], rtol=1e-5,
                                   atol=1e-6)


def test_gate_refuses_past_shared_memory(paths, tmp_path):
    """No spectral ceiling is left: no kernel's shared memory grows with S
    past a fixed bound (kernels_dense.launch_smem, the launchers' own
    measures), so the flagship at 110 columns (the most the gate took
    before), 111 and 512 builds with the same dynamic shared memory a block
    at each and no most S in its pack, and at 111 renders from .lua to PNG
    on the CPU."""
    text = open(paths["flagship_s24"]).read()
    smem = {}
    for s in (110, 111, 512):
        path = tmp_path / f"s{s}.lua"
        path.write_text(text.replace("spectrum_samples = 24", f"spectrum_samples = {s}"))
        pack = torch_build(torch_load(str(path)), "cpu").dense_pack
        assert "max_s" not in pack and pack["form"] == kd.FORM_GATE
        smem[s] = pack["smem"]
        if s == 111:
            out = str(tmp_path / "s111.png")
            assert cli.main([str(path), "--device", "cpu", "--samples", "1", "--output", out]) == 0
            with Image.open(out) as img:
                assert np.asarray(img).max() > 0
    assert smem[110] == smem[111] == smem[512]
    assert max(smem[512].values()) <= kd.SMEM_PER_BLOCK


def test_gate_takes_de_shapes_past_the_old_ceiling(tmp_path):
    """march_de_kernel reads each DE shape from the sheet, so the gate
    takes any number of them (staging every shape in shared memory held
    2,410). The julia scene's pack with its shape repeated 2,410 and 2,411
    times builds, its DE table in ceil(n / 128) consecutive rows, and no
    launcher's shared memory grows with the count."""
    import copy

    st = torch_build(torch_load(chip_smoke.write_julia_scene(str(tmp_path), 8, 4)), "cpu")
    a = {k: v.numpy() for k, v in st.arrays.items()}
    many = copy.copy(st)
    smem = []
    for count in (2410, 2411):
        many.de_shapes = list(st.de_shapes) * count
        pack = kd.build_pack(many, a)
        meta = pack["meta"]
        assert meta["n_de"] == count
        rows = sorted(meta[f"de_{field}"] for field in kd.DE_FIELDS)
        assert np.diff(rows).tolist() == [-(-count // kd.SHEET_WIDTH)] * (len(rows) - 1)
        smem.append(pack["smem"])
    assert smem[0] == smem[1] == st.dense_pack["smem"]


@pytest.mark.parametrize("which", ["regen", "pool", "one-shot", "bidirectional"])
def test_cli_renders_24_spectrum_samples(paths, tmp_path, which):
    """The flagship at S = 24 from .lua to PNG on the CPU through each of the
    simple renderer's schedulers and through the bidirectional renderer."""
    from PIL import Image

    out = tmp_path / f"{which}.png"
    before = dict(TT.launches)
    if which == "bidirectional":
        steps = bd.counters["steps"]
        assert cli.main([paths["flagship_s24_bdpt"], "--device", "cpu", "--output", str(out)]) == 0
        assert bd.counters["steps"] > steps
    else:
        with chip_smoke.scheduler(which, stage=2, cont=1):
            assert cli.main([paths["flagship_s24"], "--samples", "2", "--device", "cpu",
                             "--output", str(out)]) == 0
    assert TT.launches["bounce_core"] > before["bounce_core"]
    with Image.open(out) as img:
        assert np.asarray(img).shape == (32, 64, 3) and np.asarray(img).max() > 0


@pytest.mark.parametrize("name", ["materials_129", "tables_129", "materials_300",
                                  "textures_deep"])
def test_cli_renders_what_the_gate_refused(paths, tmp_path, name):
    """Scenes past the old gate from .lua to PNG on the CPU (materials_129
    is the case tests/test_torch_slice.py refused before)."""
    from PIL import Image

    out = tmp_path / f"{name}.png"
    assert cli.main([paths[name], "--samples", "1", "--device", "cpu", "--output", str(out)]) == 0
    with Image.open(out) as img:
        assert np.asarray(img).max() > 0


def test_gate_takes_photon_bins_in_either_gather_form(tmp_path):
    """photon_gather_kernel's row form keeps one row of 2 B + K floats a
    warp (kernels_dense.gather_smem_bytes), so it takes a photon project of
    512 film bins at S = 6 (past the 447 of a row a thread) and every bin
    count up to the most that a block's shared memory holds; one more bin
    takes the <out_row> form (gather_out_row), whose shared memory does not
    grow with B. The project is flagship_photon at its CPU size (exact
    mode: camera rows of S, lamp rows of one column); at 512 bins and at one
    past the row form's most it renders through the CLI."""
    most = max(b for b in range(1, 20000) if kd.gather_smem_bytes(b, 6) <= kd.SMEM_PER_BLOCK)
    assert most > 4 * 512 and kd.gather_smem_bytes(most + 1, 6) > kd.SMEM_PER_BLOCK
    flagship = chip_smoke.photon_scene_paths(str(tmp_path), small=True)["flagship_photon"]
    for bins, out_row in ((512, False), (most, False), (most + 1, True)):
        path = chip_smoke.photon_bins_scene(flagship, bins)
        st = torch_build(torch_load(path), "cpu")
        assert st.photon_widths == {"exact": True, "camera": 6, "lamp": 1, "bins": bins}
        assert kd.gather_out_row(bins, 6) == out_row
        assert st.dense_pack["smem"]["gather"] == kd.gather_smem_bytes(bins, 6, out_row)
        assert st.dense_pack["smem"]["gather"] <= kd.SMEM_PER_BLOCK
        if bins != most:
            out = str(tmp_path / f"bins_{bins}.png")
            assert cli.main([path, "--device", "cpu", "--samples", "1", "--output", out]) == 0
            assert np.asarray(Image.open(out)).max() > 0
