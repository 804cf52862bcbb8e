"""The CUDA kernels against their plain PyTorch version on the card (the
kernels have no CPU mode, so this skips without a CUDA device).

The module imports neither JAX nor the JAX package, so it runs on a machine
without them: ``python -m pytest --noconftest tests/test_torch_cuda.py``
(tests/conftest.py configures JAX)."""

import os

import pytest
import torch

import chip_smoke
from pyrite_tpu_torch import kernels

torch.set_num_threads(2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "prism", "tri_lamp", "many_materials"])
def test_cuda_kernels_match_plain_version(tmp_path, name):
    """The dense bounce and NEE kernels lane for lane: 0 divergent lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    paths = chip_smoke.scene_paths(str(tmp_path), width=128, height=64, spectrum_samples=6, bounces=8)
    worst = chip_smoke.check_kernels(name, paths[name], lanes=8192)
    assert worst["divergent"] == 0.0 and worst["nee_divergent"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "fractal"])
def test_cuda_draws_match_cpu(tmp_path, name):
    """philox_draws_kernel, launched twice, against rng.py's plain version
    on the card and on the CPU, bit for bit, on a render step's camera and
    bounce draws; and a render's draws: the draws the bounces of a CUDA
    render step read equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import rng, tracer

    path = (chip_smoke.scene_paths(str(tmp_path), width=128, height=64)["flagship"] if name == "flagship"
            else _de_path(str(tmp_path), name))
    assert chip_smoke.check_draws(name, path) == 0.0
    scene, film, camera, cfg = chip_smoke.load_scene(path)
    keyed = rng.KeyedDraws(9, sample0=2, samples=2)
    n = 2 * film.width * film.height
    cpu = torch.device("cpu")
    got = rng.camera_uniforms(keyed, n, cfg.spectrum_samples, "cuda")
    assert torch.equal(got.cpu(), rng.camera_plain(keyed, n, cfg.spectrum_samples, cpu))
    for b in range(cfg.bounces):
        got = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, b, "cuda")
        want = rng.bounce_plain(keyed, n, b, cfg.light_samples, scene.num_lamps, cpu)
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k].cpu(), v), (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "fractal"])
def test_cuda_bounce_launchers_run_twice(tmp_path, name):
    """Each launcher of the bounce, NEE and draw kernels, called twice with
    the same arguments, writes the same bits (the NEE kernel accumulates, so
    its brightness is restored in between)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import _build, kernels_dense as kd, tracer

    path = (chip_smoke.scene_paths(str(tmp_path), width=128, height=64)["flagship"] if name == "flagship"
            else _de_path(str(tmp_path), name))
    scene, film, camera, cfg = chip_smoke.load_scene(path)
    origin, direction, wl, keyed = chip_smoke._wavefront(film, camera, cfg, 4, 4096)
    n = origin.shape[0]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cuda")
    again = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cuda")
    for k in draws:
        assert torch.equal(draws[k], again[k]), k
    bank = kd.precompute_bank_values(scene, wl)
    t_de = kd.march_pass(scene, cfg, state) if scene.de_shapes else None
    lib = _build.load()
    bounce_name, nee_name = kd.kernel_names(scene)
    args, out, ctx = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank, t_de)
    results = []
    for _ in range(2):
        assert getattr(lib, kd._LAUNCHERS[bounce_name])(*args) == 0
        torch.cuda.synchronize()
        results.append({k: v.clone() for k, v in dict(out, **ctx).items() if k != "refl_nee"})
    for k in results[0]:
        assert torch.equal(results[0][k], results[1][k]), k
    t_sh = kd.shadow_pass(scene, cfg, out, ctx, draws) if scene.de_shapes else None
    n_args = kd.nee_kernel_args(scene, cfg, wl, out, ctx, draws, bank, t_sh)
    before = out["brightness"].clone()
    sums = []
    for _ in range(2):
        out["brightness"].copy_(before)
        assert getattr(lib, kd._LAUNCHERS[nee_name])(*n_args) == 0
        torch.cuda.synchronize()
        sums.append(out["brightness"].clone())
    assert torch.equal(sums[0], sums[1])
    if name == "flagship":  # on fractal NEE at a DE hit shadows itself (ROADMAP.md queue 3)
        assert not torch.equal(sums[0], before)


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


def _de_path(directory, name):
    if name == "fractal":
        return chip_smoke.write_fractal_scene(directory, 128, 64, 4, 3)
    if name == "julia":
        return chip_smoke.write_julia_scene(directory, 128, 64)
    if name == "two_de":
        return chip_smoke.write_two_de_scene(directory, 128, 64)
    return chip_smoke.write_terrain_de_scene(directory, width=128, height=64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fractal", "julia", "terrain_de_24", "two_de"])
def test_cuda_de_kernels_match_plain_version(tmp_path, name):
    """The DE march kernel against the plain march, as the query
    (tracer.march_de_plain), the bounce march pass and the shadow march pass
    (tracer.de_hits), bit for bit; and the bounce and NEE kernels, which read
    the passes' t after the primitives (dense or wide), against
    tracer.bounce_core. two_de puts a Mandelbulb and a cubic Julia in one
    scene, so warps at the border between the shapes' items march both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _de_path(str(tmp_path), name)
    chip_smoke.check_march(name, path, lanes=8192)
    chip_smoke.check_shadow_pass(name, path, lanes=8192)
    worst = chip_smoke.check_kernels(name, path, lanes=8192)
    assert worst["divergent"] == 0.0 and worst["nee_divergent"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fractal", "two_de"])
@pytest.mark.parametrize("cut, idle", [(8191, 0.0), (8192, 0.5)], ids=["8191_rays", "half_idle"])
def test_cuda_march_passes_with_idle_threads(tmp_path, name, cut, idle):
    """The persistent march on a wavefront whose last warp is partial
    (8,191 rays) and on one with a random half of the lanes dead (or
    without NEE, or without a ray for the query): bit-equal to the plain
    march, and the bounce and NEE kernels held as phase 3 holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _de_path(str(tmp_path), name)
    chip_smoke.check_march(name, path, lanes=8192, cut=cut, idle=idle)
    chip_smoke.check_shadow_pass(name, path, lanes=8192, cut=cut, idle=idle)
    worst = chip_smoke.check_kernels(name, path, lanes=8192, cut=cut, idle=idle)
    assert worst["divergent"] < 0.015


@pytest.mark.cuda
def test_cuda_march_counter_is_reset(tmp_path):
    """Two launches in a row of each march wrapper, and of each pass's
    launcher with the same arguments (its work counter included), give the
    same t: the counter starts from 0 on every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import _build, kernels_dense as kd, tracer

    scene, film, camera, cfg = chip_smoke.load_scene(_de_path(str(tmp_path), "two_de"))
    origin, direction, wl, keyed = chip_smoke._wavefront(film, camera, cfg, 3, 4096)
    n = origin.shape[0]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    first, second = kd.march_pass(scene, cfg, state), kd.march_pass(scene, cfg, state)
    assert torch.equal(first, second) and bool(torch.isfinite(first).any())
    args, t_de = kd.march_pass_args(scene, cfg, state)
    lib = _build.load()
    for _ in range(2):
        assert lib.pyrite_de_march_bounce(*args) == 0
        torch.cuda.synchronize()
        assert torch.equal(t_de, first)
    draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cuda")
    out, ctx = kd.launch_bounce_kernel(scene, cfg, wl, state, draws,
                                       kd.precompute_bank_values(scene, wl), first)
    shadow = kd.shadow_pass(scene, cfg, out, ctx, draws)
    assert torch.equal(shadow, kd.shadow_pass(scene, cfg, out, ctx, draws))
    args, t_sh = kd.shadow_pass_args(scene, cfg, out, ctx, draws)
    for _ in range(2):
        assert lib.pyrite_de_march_shadow(*args) == 0
        torch.cuda.synchronize()
        assert torch.equal(t_sh, shadow)
    march_args = chip_smoke._de_march_args(scene, cfg, origin, direction, scene.de_shapes[1])
    total, dist = kernels.march_de(*march_args)
    again = kernels.march_de(*march_args)
    assert torch.equal(total, again[0]) and torch.equal(dist, again[1])


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


@pytest.mark.cuda
@pytest.mark.parametrize("depths", ["per-lane", "one bounce"])
def test_cuda_indexed_draws_match_plain(tmp_path, depths):
    """philox_draws_kernel's indexed mode (rng.LaneKeys, random pixels,
    samples and depths) against rng.py's plain version on the CPU, bit for
    bit: a regeneration iteration's lane_draws (camera draws on a mask,
    zeros elsewhere) and the pool's bounce draws at one bounce."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import rng

    path = chip_smoke.scene_paths(str(tmp_path), width=128, height=64)["flagship"]
    scene, film, camera, cfg = chip_smoke.load_scene(path)
    keys, mask = chip_smoke._lane_keys(film, 3, cfg.bounces, 11)
    cpu = torch.device("cpu")
    on_cpu = rng.LaneKeys(keys.seed, keys.pixel.cpu(), keys.sample.cpu(), keys.depth.cpu())
    ls, lamps, s = cfg.light_samples, scene.num_lamps, cfg.spectrum_samples
    if depths == "per-lane":
        cam, got = rng.lane_draws(keys, s, ls, lamps, mask, "cuda")
        cam_w, want = rng.lane_draws_plain(on_cpu, s, ls, lamps, mask.cpu(), cpu)
        assert torch.equal(cam.cpu(), cam_w)
    else:
        n = keys.pixel.shape[0]
        got = rng.bounce_draws(rng.LaneKeys(keys.seed, keys.pixel, keys.sample), n, 5, ls, lamps, "cuda")
        want = rng.bounce_plain(rng.LaneKeys(keys.seed, on_cpu.pixel, on_cpu.sample), n, 5, ls, lamps, cpu)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship", "terrain_24", "fractal"])
def test_cuda_schedulers_match_one_shot(tmp_path, name):
    """A render through regeneration and through the survivor pool on the
    card equals the one-shot render: wt equal, acc within rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    directory = str(tmp_path)
    path = {
        "flagship": lambda: chip_smoke.scene_paths(directory, width=128, height=64)["flagship"],
        "terrain_24": lambda: chip_smoke.terrain_paths(directory, cells=(24,), width=128,
                                                       height=64)["terrain_24"],
        "fractal": lambda: _de_path(directory, "fractal"),
    }[name]()
    assert chip_smoke.compare_schedulers(name, path, 3, torch.cuda.get_device_name(0)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_class", "flagship_bdpt", "terrain_24_bdpt",
                                  "terrain_de_24_bdpt"])
def test_cuda_bdpt_kernels_match_plain_version(tmp_path, name):
    """The bidirectional renderer's kernels at a render's wavefront: the
    lamp kernel (start and bounces) and the bounce kernel's kRecord
    instantiation with its camera vertex against tracer.lamp_start,
    lamp_bounce_step and bounce_core(record) with every flag equal; and
    kernels_dense.shadow_query bit for bit on the connection and splat
    batches: dense_shadow_kernel on the dense scenes, wide_shadow_kernel on
    the mesh scenes, after the query march pass where the scene has a DE
    shape (the Cornell class, and terrain_de_24_bdpt: a mesh with a DE
    shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.bdpt_scene_paths(str(tmp_path), spp=1, small=True)[name]
    worst = chip_smoke.check_bdpt(name, path)["worst"]
    assert worst["divergent"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_class", "flagship_bdpt"])
def test_cuda_shadow_edge_batches_match_plain_version(tmp_path, name):
    """dense_shadow_kernel on chip_smoke.shadow_edge_batches (no ray live,
    every ray live, only each block's last ray live, M not a multiple of
    the block) bit for bit against shadow_query_plain, with (the Cornell
    class) and without a DE shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.bdpt_scene_paths(str(tmp_path), spp=1, small=True)[name]
    scene, _, _, cfg = chip_smoke._gpu_scene(path)
    with chip_smoke.kernel_march():
        assert chip_smoke.check_shadow_edges(name, scene, cfg, chip_smoke.EDGE_BOXES[name]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_class", "flagship_bdpt", "terrain_24_bdpt"])
def test_cuda_sparse_lamp_state_matches_plain_version(tmp_path, name):
    """The lamp kernel's bounce from chip_smoke.sparse_lamp_state (one lane
    in 37 alive) against tracer.lamp_bounce_step, and its dead lanes
    holding their defaults (chip_smoke.check_sparse_lamp), on the dense,
    the DE and the wide instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import rng, tracer

    path = chip_smoke.bdpt_scene_paths(str(tmp_path), spp=1, small=True)[name]
    scene, _, _, _, lamp_cfg, keyed, rays, bank = chip_smoke._bdpt_setup(path, 0)
    wl = rays[3]
    start = rng.lamp_start_draws(keyed, wl.shape[0], scene.num_lamps, wl.device)
    _, state = tracer.lamp_start(scene, wl, start)
    with chip_smoke.kernel_march():
        assert chip_smoke.check_sparse_lamp(name, scene, lamp_cfg, wl, state, keyed, bank) < 1e-3


@pytest.mark.cuda
def test_cuda_bdpt_render_matches_plain(tmp_path):
    """A Cornell-class render through the kernels against one through the
    plain versions on the card, with the same keyed draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.write_cornell_scene(str(tmp_path), 32, 32, 4, spp=1)
    chip_smoke.compare_bdpt_plain(path, 1, "card")


@pytest.mark.cuda
def test_cuda_regen_bdpt_matches_one_shot(tmp_path):
    """flagship_bdpt_deep (512 x 256, 16 + 8 bounces) at 1 spp through the
    regen scheduler and through the one-shot step on the card: wt within
    rtol 1e-6, acc within rtol 1e-4 / atol 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.bdpt_scene_paths(str(tmp_path), spp=1)["flagship_bdpt_deep"]
    assert chip_smoke.check_regen_bdpt("flagship_bdpt_deep", path, 1, "card") is None


@pytest.mark.cuda
def test_cuda_regen_bdpt_kernels_at_a_regen_wavefront(tmp_path):
    """At the first regen iteration with regenerated lanes beside lanes at
    depth >= 1 (2 spp), the bounce kernel's kRecord instantiation with the
    NEE kernel against bounce_core(record) (no divergent lane) and the
    connection batch's shadow query bit for bit (chip_smoke.regen_probe);
    the films equal one-shot's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.bdpt_scene_paths(str(tmp_path), spp=2, small=True)["flagship_bdpt_deep"]
    result = chip_smoke.check_regen_bdpt("flagship_bdpt_deep", path, 2, "card")
    assert result["regenerated"] > 0 and result["deep"] > 0 and result["live_rays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("purpose", ["LAMP_START", "LAMP_BOUNCE", "SPLAT"])
def test_cuda_bdpt_draws_match_cpu(purpose):
    """The draw kernel's words mode against rng.py's plain version on the
    CPU, bit for bit, in the affine and the indexed mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import rng

    code = getattr(rng, purpose)
    width, take, depth = {"LAMP_START": (6, 4, 0), "LAMP_BOUNCE": (4, 4, 3), "SPLAT": (18, 2, 0)}[purpose]
    n = 5000
    affine = rng.KeyedDraws(11, sample0=3, samples=2, pixel0=64)
    got = rng.purpose_words(affine, n, depth, code, width, "cuda", take)
    want = rng.purpose_uniforms(affine, n, depth, code, width, torch.device("cpu"), take)
    assert torch.equal(got.cpu(), want)
    g = torch.Generator().manual_seed(2)
    keys = rng.LaneKeys(11, torch.randint(0, 10**6, (n,), generator=g, dtype=torch.int32),
                        torch.randint(0, 512, (n,), generator=g, dtype=torch.int32),
                        torch.randint(0, 8, (n,), generator=g, dtype=torch.int32))
    on_card = rng.LaneKeys(11, keys.pixel.cuda(), keys.sample.cuda(), keys.depth.cuda())
    got = rng.purpose_words(on_card, n, 0, code, width, "cuda", take)
    assert torch.equal(got.cpu(), rng.purpose_uniforms(keys, n, 0, code, width, torch.device("cpu"), take))


def _texture_paths(directory):
    size = dict(width=96, height=64, spectrum_samples=6, bounces=4, spp=4)
    return {
        "textures": chip_smoke.write_textures_scene(directory, **size),
        "textures_512": chip_smoke.write_textures_scene(directory, **size, tiles=(16, 16)),
        "textures_1k": chip_smoke.write_textures_scene(f"{directory}/1k", **size, texture_size=1024),
        "textures_bdpt": chip_smoke.write_textures_scene(directory, 48, 32, 6, 4, spp=2,
                                                         renderer="bidirectional"),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["textures", "textures_512", "textures_1k"])
def test_cuda_prog_kernels_match_plain_version(tmp_path, name):
    """The kProg instantiations of the bounce and NEE kernels (image
    textures, normal maps, a fresnel colour, a textured lamp, a ray-reading
    sky; dense, a mesh with vt through the wide kernels, and the dense scene
    with a 1024 x 1024 checker and normal map) lane for lane against
    tracer.bounce_core: flags exact, 0 divergent lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import kernels_dense as kd

    path = _texture_paths(str(tmp_path))[name]
    scene = chip_smoke.load_scene(path)[0]
    assert scene.dense_pack["prog"] and scene.use_clusters == (name == "textures_512")
    chip_smoke._zero_counts()
    worst = chip_smoke.check_kernels(name, path)
    assert worst["divergent"] == 0.0 and worst["nee_divergent"] == 0.0
    assert kd.launches[kd.kernel_names(scene)[0]] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,geometry", [("textures", "dense"), ("textures_512", "wide")])
def test_cuda_prog_render_takes_the_kernels(tmp_path, name, geometry):
    """The CLI renders the textures scene (and the 512-triangle mesh with
    vt through wide_bounce_kernel) with every bounce iteration on the kProg
    kernels and none by the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _texture_paths(str(tmp_path))[name]
    launches = chip_smoke.render_end_to_end(path, 2, "card", str(tmp_path))
    assert launches[f"{geometry}_bounce_kernel<prog>"] == launches["bounces"] > 0


@pytest.mark.cuda
def test_cuda_prog_bdpt_matches_plain_version(tmp_path):
    """The bidirectional renderer's kernels on the textures scene: the lamp
    kernel's and the kRecord bounce's kProg instantiations against their
    plain versions (flags exact), the lamp vertices' colours through
    program_colors_kernel against the plain programs, and a CLI render with
    no plain step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _texture_paths(str(tmp_path))["textures_bdpt"]
    checked = chip_smoke.check_bdpt("textures_bdpt", path)
    assert "colors" in checked["worst"] and checked["worst"]["divergent"] == 0.0
    launches = chip_smoke.render_bdpt(path, 2, "card", str(tmp_path))[0]
    assert launches["program_colors_kernel"] > 0 and launches["dense_lamp_kernel<prog>"] > 0


# --- the rest of the scene gate (chip_smoke.gate_paths, at test sizes) -------------


def _gate_paths(directory):
    """chip_smoke.gate_paths' scenes at 128 x 64 (the terrains at 24 cells,
    materials_300 and textures_deep at full count, de_130 at 64 x 32, and
    de_520 at 32 x 16: past the 512 shapes the march kernel's shared
    memory holds without opting in), with the flagship at S = 17, 33 and
    110 (one column past 16 and 32, the gate's former ceiling), terrain_24 at S =
    32, the julia scene at 32 x 32 and S = 24, and flagship_s24_bdpt."""
    flagship = chip_smoke.scene_paths(directory, width=128, height=64, spectrum_samples=6,
                                      bounces=8)["flagship"]
    spectra = lambda s: [("spectrum_samples = 6", f"spectrum_samples = {s}")]  # noqa: E731
    spheres = dict(count=300, width=128, height=64, distinct=True, emissive=150, planes=130,
                   spectrum_samples=10)
    julia = os.path.join(directory, "julia_s24")
    os.makedirs(julia, exist_ok=True)
    return {
        "sunlit_terrain_24": chip_smoke.write_sunlit_terrain_scene(directory, 24, 128, 64),
        "sunlit_terrain_24_bdpt": chip_smoke.write_sunlit_terrain_scene(
            directory, 24, 128, 64, spp=2, renderer="bidirectional"),
        "flagship_s20": chip_smoke.add_objects(flagship, [chip_smoke.SUN], "flagship_s20",
                                               spectra(20)),
        "flagship_s32": chip_smoke.add_objects(flagship, [chip_smoke.SUN], "flagship_s32",
                                               spectra(32)),
        "flagship_s64": chip_smoke.add_objects(flagship, [], "flagship_s64", spectra(64)),
        "flagship_s17": chip_smoke.add_objects(flagship, [], "flagship_s17", spectra(17)),
        "flagship_s33": chip_smoke.add_objects(flagship, [], "flagship_s33", spectra(33)),
        "flagship_s110": chip_smoke.add_objects(flagship, [], "flagship_s110", spectra(110)),
        "flagship_s24_bdpt": chip_smoke.add_objects(flagship, [], "flagship_s24_bdpt", spectra(24) + [
            ("renderer.simple {", "renderer.bidirectional {\n        light_bounces = 3,"),
            ("pixel_samples = 256", "pixel_samples = 2")]),
        "terrain_24_s32": chip_smoke.add_objects(
            chip_smoke.terrain_paths(directory, cells=(24,), width=128, height=64)["terrain_24"], [],
            "terrain_24_s32", [("spectrum_samples = 4,", "spectrum_samples = 32,")]),
        "julia_s24": chip_smoke.write_julia_scene(julia, 32, 32, spectrum_samples=24),
        "materials_300": chip_smoke.write_spheres_scene(directory, **spheres),
        "materials_300_bdpt": chip_smoke.write_spheres_scene(directory, **spheres,
                                                             renderer="bidirectional"),
        "textures_deep": chip_smoke.write_textures_scene(directory, 128, 96, 6, 4, spp=4,
                                                         deep=True),
        "de_130": chip_smoke.write_de_many_scene(directory, 130, 64, 32),
        "de_520": chip_smoke.write_de_many_scene(directory, 520, 32, 16),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sunlit_terrain_24", "flagship_s20", "flagship_s32",
                                  "flagship_s64", "materials_300", "textures_deep", "de_130",
                                  "de_520", "flagship_s17", "flagship_s33", "flagship_s110",
                                  "terrain_24_s32", "julia_s24", "flagship_s24_bdpt"])
def test_cuda_gate_kernels_match_plain_version(tmp_path, name):
    """The bounce and NEE kernels lane for lane on the scenes the gate
    refused before: directional lamps, S = 20, 32 and 64, tables past 128
    rows read from the baked colour table, an 82-instruction program at
    stack depth 12, 130 and 520 DE shapes: 0 divergent lanes. The edges of
    the gate form's streamed (kStream) kernels: S = 17, 33 and 110, a mesh
    at S = 32, a DE scene at S = 24 (at bounce 0: the plain march on the
    card is slow) and the kRecord bounce with its chain factors at S = 24
    (chip_smoke.wide_rows_case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _gate_paths(str(tmp_path))[name]
    if name == "flagship_s24_bdpt":
        for bounce in (0, 1):
            chip_smoke.wide_rows_case(path, bounce, record=True)
        return
    one = name.startswith("de_") or name == "julia_s24"
    worst = chip_smoke.check_kernels(name, path, lanes=8192, bounces=1 if one else 3)
    assert worst["divergent"] == 0.0 and worst["nee_divergent"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship_s33", "flagship_s110", "terrain_24_s32"])
def test_cuda_wide_rows_match_plain_version(tmp_path, name):
    """--wide-rows' comparison (chip_smoke.wide_rows_case) at bounces 0
    and 1, and the kRecord bounce with its chain factors: flags bit-equal
    to the plain version's, vectors within rtol 1e-3 / atol 1e-4, no
    divergent lane; the digests cover every output and are those of the
    same launch repeated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _gate_paths(str(tmp_path))[name]
    for bounce in (0, 1):
        for record in (False, True):
            digests, _ = chip_smoke.wide_rows_case(path, bounce, record=record)
            assert "nee brightness" in digests and "bounce refl_nee" in digests
            assert ("bounce color_prob" in digests) == record
            assert chip_smoke.wide_rows_case(path, bounce, record=record)[0] == digests


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sunlit_terrain_24", "flagship_s20", "flagship_s64",
                                  "materials_300", "textures_deep"])
def test_cuda_gate_renders_take_the_kernels(tmp_path, name):
    """The CLI from .lua to PNG on the card through regeneration, every
    bounce through the scene's kernels (chip_smoke.render_end_to_end), at S
    up to 64 with no ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _gate_paths(str(tmp_path))[name]
    launches = chip_smoke.render_end_to_end(path, 2, "test", str(tmp_path))
    assert launches["bounces"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sunlit_terrain_24_bdpt", "materials_300_bdpt"])
def test_cuda_gate_bdpt_matches_plain_version(tmp_path, name):
    """The bidirectional renderer's kernels against their plain versions
    (chip_smoke.check_bdpt) with directional lamps (which start no lamp
    path) and with 150 sphere lamps and the baked colour table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _gate_paths(str(tmp_path))[name]
    checked = chip_smoke.check_bdpt(name, path)
    assert checked["worst"] is not None


@pytest.mark.cuda
def test_cuda_gate_draws_past_16_samples(tmp_path):
    """philox_draws_kernel at S = 64 (camera rows of 69 words, staged
    whole) bit for bit against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = _gate_paths(str(tmp_path))["flagship_s64"]
    assert chip_smoke.check_draws("flagship_s64", path) == 0.0


def _photon_paths(directory):
    """flagship_photon and textures_photon at their phase-7 size, and
    terrain_24 and the julia scene as photon projects (a mesh and a DE
    scene)."""
    paths = chip_smoke.photon_scene_paths(directory)
    extra = "bounces = 4, " + chip_smoke.PHOTON_EXTRA % (20000, 4, 1, "0.1")
    for name, path in (("terrain_24", chip_smoke.terrain_paths(directory, cells=(24,))["terrain_24"]),
                       ("julia", chip_smoke.write_julia_scene(directory, 128, 128, 4, 4))):
        with open(path) as fh:
            text = fh.read().replace("renderer.simple", "renderer.photon_mapping").replace(
                "bounces = 4,", extra, 1)
        paths[name + "_photon"] = path[:-4] + "_photon.lua"
        with open(paths[name + "_photon"], "w") as fh:
            fh.write(text)
    return paths


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship_photon", "textures_photon"])
def test_cuda_photon_gather_matches_plain_version(tmp_path, name):
    """photon_gather_kernel against its plain version on every camera
    bounce of the first chunk (chip_smoke.check_photon): num_neighbors and
    fresh_cnt equal, the bins within rtol 1e-5 / atol 1e-7, in exact
    (flagship_photon) and interpolation mode (textures_photon, through the
    kProg kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    checked = chip_smoke.check_photon(name, _photon_paths(str(tmp_path))[name])
    assert checked["worst"]["gather"] < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship_photon", "terrain_24_photon", "julia_photon"])
def test_cuda_record_chain_factors_match_plain_version(tmp_path, name):
    """The kRecord bounce kernels' chain factors (color_prob, color_prog,
    path_prob, reflected) against tracer.bounce_core(record=True) on a
    dense, a mesh and a DE photon project (chip_smoke.check_record_chain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    assert chip_smoke.check_record_chain(name, _photon_paths(str(tmp_path))[name]) < 1e-3


@pytest.mark.cuda
def test_cuda_photon_gather_edge_maps_match_plain_version():
    """photon_gather_kernel against its plain version on the hand-built maps
    of chip_smoke.gather_edge_maps (clipped duplicates, a cell past the
    cap, wrapped keys, photons at the radius, 512 bins in exact mode), as
    chip_smoke.check_gather_edges holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    assert chip_smoke.check_gather_edges("card") < 1e-5


@pytest.mark.cuda
def test_cuda_photon_render_of_512_bins(tmp_path):
    """flagship_photon at 512 film bins passes the gate and renders through
    photon_gather_kernel (chip_smoke.render_photon)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    path = chip_smoke.photon_bins_scene(_photon_paths(str(tmp_path))["flagship_photon"], 512)
    launches = chip_smoke.render_photon(path, 1, "card", str(tmp_path))[0]
    assert launches["photon_gather_kernel"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship_photon", "textures_photon"])
def test_cuda_photon_render_takes_the_kernels(tmp_path, name):
    """A photon render through the CLI on the card (chip_smoke.render_photon:
    every camera bounce through the kRecord kernel, every lamp step through
    the lamp kernel, every gather through photon_gather_kernel, no plain
    version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    launches = chip_smoke.render_photon(_photon_paths(str(tmp_path))[name], 1, "card", str(tmp_path))[0]
    assert launches["photon_gather_kernel"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("purpose", ["PHOTON_WL", "FRESH"])
def test_cuda_photon_draws_match_cpu(purpose):
    """The photon renderer's draws (rng.photon_wavelengths,
    rng.fresh_wavelengths) on the card equal the CPU's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import rng

    keyed = rng.KeyedDraws(13, sample0=7, pixel0=256)
    span, cpu = (380.0, 780.0), torch.device("cpu")
    if purpose == "PHOTON_WL":
        got, want = (rng.photon_wavelengths(keyed, 5000, span, dev) for dev in ("cuda", cpu))
        assert torch.equal(got.cpu(), want)
        return
    for dev_got, dev_want in zip(rng.fresh_wavelengths(keyed, 5000, 3, 6, span, "cuda"),
                                 rng.fresh_wavelengths(keyed, 5000, 3, 6, span, cpu)):
        assert torch.equal(dev_got.cpu(), dev_want)


# --- kernel A in every form the renderers launch, and D -----------------------


@pytest.fixture(scope="module")
def record_paths(tmp_path_factory):
    """The scenes of chip_smoke.RECORD_FORMS, written once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return chip_smoke.record_scene_paths(str(tmp_path_factory.mktemp("record")))


@pytest.fixture(scope="module")
def a_parent_form(tmp_path_factory):
    """The library built from csrc/ with A's parent code switched back on
    (chip_smoke.A_PARENT_FORM: the camera vertex stored one thread a lane,
    the kProg camera walk staged past 16 columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return chip_smoke.build_variants(str(tmp_path_factory.mktemp("a_parent")),
                                     {"parent_form": chip_smoke.A_PARENT_FORM}, tag="record")


@pytest.mark.cuda
@pytest.mark.parametrize("label,key,chain", chip_smoke.RECORD_FORMS,
                         ids=[key for _, key, _ in chip_smoke.RECORD_FORMS])
def test_cuda_record_forms_match_plain_version_and_parent_code(record_paths, a_parent_form, label,
                                                                key, chain):
    """Each form of A at camera bounces 0 and 1 against the plain version
    (chip_smoke.check_record_form: flags exact, vectors rtol 1e-3 / atol
    1e-4), and every output bit-equal to the parent's code on the same
    inputs."""
    found, worst = chip_smoke.check_record_form(label, record_paths[key], chain, a_parent_form)
    assert worst < 1.0
    for bounce, digests in found.items():
        bad = [k for k, v in digests["build"].items() if digests["parent_form"][k] != v]
        assert not bad, f"{label} bounce {bounce}: {bad} differ from the parent's code"


@pytest.mark.cuda
def test_cuda_vertex_colors_edges_match_plain_version(record_paths):
    """program_colors_kernel against its plain version on
    chip_smoke.color_edge_batches of textures_bdpt, with and without a
    baked table (chip_smoke.check_color_edges: rtol 1e-3 / atol 1e-4)."""
    path = record_paths["textures_bdpt"]
    rays, bank = chip_smoke._bdpt_setup(path, 0)[6:]
    found, worst = chip_smoke.check_color_edges("textures_bdpt", path, rays[3], bank)
    assert len(found) == 10 and worst < 1e-3


@pytest.mark.cuda
def test_cuda_textures_photon_takes_the_streamed_record_form(tmp_path):
    """A textures_photon render (S + G = 70 columns in its camera walk)
    runs every camera bounce through the <record,prog> kernel, whose
    launcher passes the streamed form's shared memory at 70 columns
    (pyrite_bounce_record_smem against kernels_dense.record_smem_bytes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import _build, kernels_dense as kd

    launches = chip_smoke.render_photon(_photon_paths(str(tmp_path))["textures_photon"], 1, "card",
                                        str(tmp_path))[0]
    assert launches["dense_bounce_kernel<record,prog>"] == launches["photon_camera_bounces"] > 0
    for s in (6, 17, 70):
        for de in (0, 1):
            assert _build.load().pyrite_bounce_record_smem(s, de, kd.FORM_PROG) == (
                kd.record_smem_bytes(s, de, kd.FORM_PROG, 0))


# --- spectral widths past the kernels' old ceilings -------------------------------


@pytest.fixture(scope="module")
def wide_paths(tmp_path_factory):
    """The scenes of chip_smoke.wide_paths, written once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return chip_smoke.wide_paths(str(tmp_path_factory.mktemp("wide")))


@pytest.fixture(scope="module")
def prog_staged(tmp_path_factory):
    """The library built from csrc/ with the kProg bounce and NEE staged at
    any S (chip_smoke.PROG_STAGED_FORM: the form the chunks replace past
    16 columns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import _build

    libs = chip_smoke.build_variants(str(tmp_path_factory.mktemp("prog_staged")),
                                     {"staged": chip_smoke.PROG_STAGED_FORM}, tag="wide-prog")
    return dict(libs, build=(_build.load(), _build.build_log))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["textures_s128", "textures_deep_s128"])
def test_cuda_prog_kernels_past_16_columns_match_plain_version(wide_paths, name):
    """The kProg bounce and NEE at S = 128 (their chunked forms: a lane's own
    colour row made and streamed 16 columns at a time) against the plain
    version (chip_smoke.check_kernels: flags exact, vectors rtol 1e-3 /
    atol 1e-4, no divergent lane), then at bounces 0 and 1 on the main
    path's wavefront (chip_smoke.wide_rows_case), whose digests the same
    launches repeated give again."""
    worst = chip_smoke.check_kernels(name, wide_paths[name], lanes=8192, bounces=2)
    assert worst["divergent"] == worst["nee_divergent"] == 0.0
    for bounce in (0, 1):
        digests, err = chip_smoke.wide_rows_case(wide_paths[name], bounce)
        assert err < 1e-3 and chip_smoke.wide_rows_case(wide_paths[name], bounce)[0] == digests


@pytest.mark.cuda
@pytest.mark.parametrize("s", [24, 64])
def test_cuda_prog_chunks_bit_equal_to_the_staged_form(tmp_path, prog_staged, s):
    """The kProg bounce and NEE past 16 columns (chunks) against the same
    kernels staged at [BLOCK, S] (the form they replace, PROG_STAGED_FORM) on
    the textures scene at 256 x 192, bounces 0 and 1: every output bit for
    bit (chip_smoke._prog_libs' digests)."""
    path = chip_smoke.write_textures_scene(str(tmp_path), 256, 192, s, 4, spp=2)
    for bounce in (0, 1):
        digests, _ = chip_smoke._prog_libs(f"textures_s{s}", path, prog_staged, ["staged", "build"],
                                           "card", bounce)
        bad = [k for k, v in digests["build"].items() if digests["staged"][k] != v]
        assert not bad, f"S = {s} bounce {bounce}: {bad} differ from the staged form"


@pytest.mark.cuda
def test_cuda_draws_at_512_columns_match_cpu(wide_paths):
    """philox_draws_kernel at S = 512 (camera rows of 517 words, staged 92
    at a time) in both modes bit for bit against the CPU
    (chip_smoke.check_draws)."""
    assert chip_smoke.check_draws("flagship_s512_small", wide_paths["flagship_s512_small"]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flagship_photon_s512_small", "textures_photon_512_small"])
def test_cuda_photon_past_the_old_ceilings_matches_plain_version(wide_paths, name):
    """chip_smoke.check_photon past the old ceilings: the gather at K = 512
    fresh wavelengths (flagship_photon at S = 512, exact mode: its sums out
    of the warp's row, its values 64 wavelengths at a time), and A's kProg
    form at S + G = 518 columns with the lamp walk at 513
    (textures_photon at 512 bins): counts equal, bins within rtol 1e-5,
    the record fields and lamp vertices within rtol 1e-3 / atol 1e-4."""
    checked = chip_smoke.check_photon(name, wide_paths[name])
    assert checked["worst"]["gather"] < 1.0 and checked["worst"]["record"] < 1e-3


@pytest.mark.cuda
def test_cuda_gate_measures_equal_the_launchers():
    """kernels_dense's measures of each kernel's dynamic shared memory (the
    gate's) against what the launchers pass, at S from 1 to 4,096, in each
    form, with and without DE shapes: the bounce, kRecord and NEE kernels,
    the draws' camera rows and the gather at film bins and fresh
    wavelengths on both sides of FRESH_CHUNK."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from pyrite_tpu_torch import _build, kernels_dense as kd, rng

    lib = _build.load()
    for s in (1, 6, 16, 17, 64, 87, 88, 102, 128, 449, 512, 4096):
        assert lib.pyrite_draws_smem(s) == rng.draws_smem_bytes(s), s
        for form in (kd.FORM_SIMPLE, kd.FORM_PROG, kd.FORM_GATE):
            stack = 8 if form == kd.FORM_PROG else 0
            extra = kd._stack_bytes(form, stack)
            assert lib.pyrite_nee_smem(s, form) + extra * (form == kd.FORM_PROG) == (
                kd.nee_smem_bytes(s, form, stack)), (s, form)
            for de in (0, 1):
                assert lib.pyrite_bounce_smem(s, de, form) + extra == kd.bounce_smem_bytes(
                    s, de, form, stack), (s, de, form)
                assert lib.pyrite_bounce_record_smem(s, de, form) + extra == kd.record_smem_bytes(
                    s, de, form, stack), (s, de, form)
    for bins in (64, 512, 7085, 7086, 10000):
        for k in (1, 6, 64, 65, 512):
            for out_row in (0, 1):
                assert lib.pyrite_gather_smem(bins, k, out_row) == kd.gather_smem_bytes(
                    bins, k, out_row), (bins, k, out_row)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["textures_s512", "textures_deep_s128", "flagship_s512",
                                  "textures_photon_512", "flagship_bdpt_s128"])
def test_cuda_wide_renders_take_the_kernels(wide_paths, tmp_path, name):
    """The five renders of chip_smoke.wide_step from .lua to PNG on the
    card, every bounce through the scene's kernels, the launchers' shared
    memory the gate's (chip_smoke.check_launch_smem)."""
    assert chip_smoke.check_launch_smem({name: wide_paths[name]}) > 0
    if name == "textures_photon_512":
        launches = chip_smoke.render_photon(wide_paths[name], 1, "card", str(tmp_path))[0]
        assert launches["dense_bounce_kernel<record,prog>"] > 0 and launches["photon_gather_kernel"] > 0
    elif name == "flagship_bdpt_s128":
        launches = chip_smoke.render_bdpt(wide_paths[name], 1, "card", str(tmp_path))[0]
        assert launches["dense_bounce_kernel<record>"] > 0
    else:
        assert chip_smoke.render_end_to_end(wide_paths[name], 1, "card", str(tmp_path))["bounces"] > 0


# --- the gate's last refusals -------------------------------------------------------


@pytest.fixture(scope="module")
def gate_last_paths(tmp_path_factory):
    """The scenes of chip_smoke.gate_last_paths, written once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return chip_smoke.gate_last_paths(str(tmp_path_factory.mktemp("gate_last")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["planes", "textures_deep80"])
def test_cuda_gate_last_kernels_match_plain_version(gate_last_paths, name):
    """The dense bounce and NEE kernels on a scene of planes alone (no
    primitive, no DE shape) and the kProg ones on a colour program lowered
    in Sethi-Ullman order against the plain version (chip_smoke
    check_kernels: flags exact, vectors rtol 1e-3 / atol 1e-4, no divergent
    lane); the Sethi-Ullman order's outputs bit-equal to the expression's
    order's (chip_smoke.hold_stack_orders)."""
    worst = chip_smoke.check_kernels(name, gate_last_paths[name], lanes=8192, bounces=2)
    assert worst["divergent"] == worst["nee_divergent"] == 0.0
    if name == "textures_deep80":
        su, natural = chip_smoke.hold_stack_orders(name, gate_last_paths[name], lanes=4096)
        assert su < natural


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 130, 2411])
def test_cuda_march_matches_plain_at_any_shape_count(gate_last_paths, count):
    """march_de_kernel, each item's shape read from the sheet, at 1, 130
    and 2,411 DE shapes: the bounce, shadow and query passes' t bit-equal
    to the plain version (chip_smoke.check_march_shapes)."""
    from pyrite_tpu_torch import kernels_dense as kd

    before = kd.launches["de_query_pass"]
    name = f"de_{count}"
    assert chip_smoke.check_march_shapes(name, gate_last_paths[name], lanes=256) == 0.0
    assert kd.launches["de_query_pass"] > before


@pytest.mark.cuda
def test_cuda_out_row_gather_matches_plain_and_row_forms(gate_last_paths):
    """photon_gather_kernel's <out_row> form at 7,086 and 10,000 bins
    against the plain version (counts exact, bins rtol 1e-5), and at 7,085
    bins bit-equal to the row form (chip_smoke.check_out_row_gather,
    hold_gather_forms)."""
    for bins in (7086, 10000):
        name = f"flagship_photon_{bins}_small"
        assert chip_smoke.check_out_row_gather(name, gate_last_paths[name]) < 1e-3
    assert chip_smoke.hold_gather_forms("flagship_photon_7085_small",
                                        gate_last_paths["flagship_photon_7085_small"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["planes", "planes_bdpt", "textures_deep80",
                                  "textures_deep80_bdpt", "de_2411", "flagship_photon_7086_small"])
def test_cuda_gate_last_renders_take_the_kernels(gate_last_paths, tmp_path, name):
    """Phase 10's renders from .lua to PNG on the card, every bounce
    through the scene's kernels (the march passes on de_2411, the gather's
    <out_row> form past 7,085 bins), the launchers' shared memory the
    gate's (chip_smoke.check_launch_smem)."""
    path = gate_last_paths[name]
    assert chip_smoke.check_launch_smem({name: path}) > 0
    if name.startswith("flagship_photon"):
        launches = chip_smoke.render_photon(path, 1, "card", str(tmp_path))[0]
        assert launches["photon_gather_kernel<out_row>"] > 0 == launches["photon_gather_kernel"]
    elif name.endswith("_bdpt"):
        assert chip_smoke.render_bdpt(path, 1, "card", str(tmp_path))[0]["camera_bounces"] > 0
    else:
        launches = chip_smoke.render_end_to_end(path, 1, "card", str(tmp_path),
                                                passes=name == "de_2411")
        assert launches["bounces"] > 0
        if name == "de_2411":
            assert launches["de_march_pass"] > 0
