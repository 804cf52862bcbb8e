"""The multi-device render on the CPU (pyrite_tpu_torch/parallel/mesh.py, the
renderers' render_sharded and cli.render_rank): gloo worlds of CPU
processes started by parallel.spawn, on tests/test_parallel.py's 16 x 16
scenes and a small flagship.

Each rank renders its own global samples with keyed draws, so the merged
film is the one-process film to summation order: wt equal where the weights
are ones (the simple renderer), acc within rtol 1e-5; the bidirectional and
photon films, whose weights are not all ones, wt within rtol 1e-6 and acc
within rtol 1e-4 / atol 1e-6 (tests/test_torch_regen_bdpt.py's scheduler
tolerance). Cases: every scheduler at world 2 (simple one-shot,
regeneration and the pool; BDPT fused, two-phase and regen; photon), 13
samples at world 3 (the JAX package's sharded total), a sharded checkpoint
resumed (one-shot and regen, whose lane_samples hold every rank's planes),
merge_films bit for bit against the JAX package's, the world-2 film against
the JAX package's render_sharded on its 8-device CPU mesh statistically,
--profile's trace per rank, and a world whose rank raises or misses its
deadline.

The renders of a world are batched in one spawn (cli.render_ranks), each
rank its own process; OMP_NUM_THREADS keeps each to 2 threads."""

import os
import time

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu_torch import cli
from pyrite_tpu_torch.parallel import mesh
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.renderers import photon as ph
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import build_scene
from test_parallel import BDPT_SCENE, POOLED_SCENE, SCENE

torch.set_num_threads(2)

DEADLINE = 120  # seconds a world may take
PHOTON_SCENE = SCENE.replace("renderer.simple {", "renderer.photon_mapping {").replace(
    "light_samples = 2,", "light_samples = 2, photons = 800, photon_bounces = 3, radius = 0.4,")
TWO_PHASE_SCENE = BDPT_SCENE.replace("light_bounces = 3,", "light_bounces = 24,")
ONE_SHOT = {"PYRITE_TPU_REGEN": "0"}
FORCE_REGEN_BDPT = {"renderers.bidirectional.REGEN_BDPT_MIN_BOUNCES": 1}
TWO_PLANES = {"renderers.simple.REGEN_MAX_PLANES": 2}

# name: (scene, spp, env, attrs, renderer, which counter shows the scheduler)
RENDERS = {
    "simple_one_shot": ("scene", 5, ONE_SHOT, None, simple, None),
    "simple_regen": ("scene", 5, None, None, simple, ("simple", "regen_launches")),
    "flagship_regen": ("flagship", 3, None, None, simple, ("simple", "regen_launches")),
    "simple_pool": ("pooled", 3, ONE_SHOT, None, simple, ("simple", "pool_stages")),
    "bdpt_fused": ("bdpt", 3, None, None, bd, ("bidirectional", "steps")),
    "bdpt_two_phase": ("two_phase", 2, None, None, bd, ("bidirectional", "compactions")),
    "bdpt_regen": ("bdpt", 5, None, FORCE_REGEN_BDPT, bd, ("bidirectional", "regen_bdpt_walks")),
    "photon": ("photon", 3, None, None, ph, ("photon", "maps")),
}
STAT_SPP = 64  # the statistical case's samples, each side


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = tmp_path_factory.mktemp("parallel")
    out = {}
    for name, text in (("scene", SCENE), ("pooled", POOLED_SCENE), ("bdpt", BDPT_SCENE),
                       ("two_phase", TWO_PHASE_SCENE), ("photon", PHOTON_SCENE)):
        out[name] = str(directory / f"{name}.lua")
        with open(out[name], "w") as fh:
            fh.write(text)
    out["flagship"] = chip_smoke.scene_paths(str(directory), width=32, height=16,
                                             spectrum_samples=4, bounces=8)["flagship"]
    out["dir"] = str(directory)
    return out


def _job(paths, scene, spp, env=None, attrs=None, *extra, seed=0):
    out = os.path.join(paths["dir"], f"{scene}_{spp}_{seed}_{len(extra)}.png")
    return dict(argv=[paths[scene], "--device", "cpu", "--samples", str(spp), "--seed", str(seed),
                      "--output", out, *extra], env=env, attrs=attrs)


def _spawn(fn, size, args, timeout=DEADLINE):
    with pytest.MonkeyPatch.context() as m:
        m.setenv("OMP_NUM_THREADS", "2")
        return mesh.spawn(fn, ["cpu"] * size, "gloo", args=args, timeout=timeout)


def _checkpoint_jobs(paths, kind):
    ck = os.path.join(paths["dir"], f"ck_{kind}.npz")
    env, attrs = (ONE_SHOT, None) if kind == "one_shot" else (None, TWO_PLANES)
    first = _job(paths, "scene", 8, env, attrs, "--checkpoint", ck, "--preview-interval", "0")
    resumed = _job(paths, "scene", 16, env, attrs, "--checkpoint", ck, "--preview-interval", "1e9")
    return ck, [first, resumed]


@pytest.fixture(scope="module")
def world2(paths):
    """One world of 2 ranks: every render of RENDERS, the checkpointed
    renders (each kind's first job writes its file at every round, the
    second resumes from it and writes none) and the statistical case's
    films."""
    jobs = [_job(paths, scene, spp, env, attrs) for scene, spp, env, attrs, _, _ in RENDERS.values()]
    checkpoints = {}
    for kind in ("one_shot", "regen"):
        ck, pair = _checkpoint_jobs(paths, kind)
        checkpoints[kind] = ck
        jobs += pair
    jobs.append(_job(paths, "scene", STAT_SPP, ONE_SHOT, None, seed=1))
    trace_dir = os.path.join(paths["dir"], "traces")
    jobs.append(_job(paths, "scene", 1, ONE_SHOT, None, "--profile", trace_dir))
    started = time.perf_counter()
    ranks = _spawn(cli.render_ranks, 2, (jobs,))
    print(f"world of 2: {len(jobs)} renders in {time.perf_counter() - started:.1f} s")
    n = len(RENDERS)
    return {"renders": dict(zip(RENDERS, zip(ranks[0][:n], ranks[1][:n]))),
            "checkpoint": {"one_shot": ranks[0][n + 1], "regen": ranks[0][n + 3]},
            "ck_files": checkpoints,
            "stat": ranks[0][n + 4], "traces": trace_dir}


_SCENES = {}


def _one_process(path, spp, renderer, env=None, attrs=None, seed=0, monkeypatch=None):
    """The film of the same render in this process alone."""
    for name, value in (env or {}).items():
        monkeypatch.setenv(name, value)
    for name, value in (attrs or {}).items():
        module, attr = name.rsplit(".", 1)
        monkeypatch.setattr({"renderers.bidirectional": bd, "renderers.simple": simple}[module],
                            attr, value)
    if path not in _SCENES:
        project_data = load_project(path)
        _SCENES[path] = (project_data, build_scene(project_data, "cpu"))
    project_data, scene = _SCENES[path]
    _, acc, wt = renderer.render(project_data, scene, seed=seed, max_samples=spp)
    return acc, wt


def _assert_same(got, want, unit_weights):
    (acc, wt), (acc_w, wt_w) = got, want
    assert float(wt.sum()) > 0
    if unit_weights:
        assert torch.equal(wt, wt_w), f"wt differs in {int((wt != wt_w).sum())} bins"
        torch.testing.assert_close(acc, acc_w, rtol=1e-5, atol=0.0)
    else:
        torch.testing.assert_close(wt, wt_w, rtol=1e-6, atol=0.0)
        torch.testing.assert_close(acc, acc_w, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(RENDERS))
def test_merged_film_equals_one_process_film(paths, world2, monkeypatch, name):
    """(a) At world 2 each path's merged film is the one-process film;
    both ranks rendered (their launch counts), through the scheduler the
    case names."""
    scene, spp, env, attrs, renderer, counter = RENDERS[name]
    rank0, rank1 = world2["renders"][name]
    want = _one_process(paths[scene], spp, renderer, env, attrs, monkeypatch=monkeypatch)
    _assert_same((rank0["acc"], rank0["wt"]), want, unit_weights=renderer is simple)
    for rank in (rank0, rank1):
        assert rank["counts"]["tracer"]["bounces"] + rank["counts"]["bidirectional"][
            "camera_bounces"] + rank["counts"]["photon"]["camera_bounces"] > 0, rank["counts"]
        if counter is not None:
            assert rank["counts"][counter[0]][counter[1]] > 0, (counter, rank["counts"])
    if name == "simple_one_shot":
        assert rank0["counts"]["simple"]["regen_launches"] == 0
    if name == "bdpt_fused":
        assert rank0["counts"]["bidirectional"]["regen_bdpt_walks"] == 0
    # the CLI's render merges after every round and at the end
    assert rank0["counts"]["merges"]["calls"] >= 2


def test_thirteen_samples_at_world_three(paths):
    """(b) 13 samples over 3 ranks through regeneration: wt sums to 13 x
    16 x 16 x 4, the total tests/test_parallel.py::
    test_sharded_renders_exact_sample_count asserts for the JAX package, and
    the film is the one-process film."""
    ranks = _spawn(cli.render_ranks, 3, ([_job(paths, "scene", 13)],))
    rank0 = ranks[0][0]
    assert float(rank0["wt"].sum()) == 13 * 16 * 16 * 4
    assert all(r[0]["counts"]["simple"]["regen_launches"] > 0 for r in ranks)
    _assert_same((rank0["acc"], rank0["wt"]), _one_process(paths["scene"], 13, simple),
                 unit_weights=True)


@pytest.mark.parametrize("kind", ["one_shot", "regen"])
def test_sharded_checkpoint_resumes_exactly(paths, world2, monkeypatch, kind):
    """(c) Checkpointed at 8 samples by the CLI's rank 0, resumed to 16:
    the straight 16-sample film. Under regeneration the checkpoint's
    lane_samples holds both ranks' planes, [2 x 2, H, W] with two planes a
    rank (REGEN_MAX_PLANES = 2), each plane at 2 samples."""
    rank0 = world2["checkpoint"][kind]
    env, attrs = (ONE_SHOT, None) if kind == "one_shot" else (None, TWO_PLANES)
    with np.load(world2["ck_files"][kind]) as f:
        lanes = f["lane_samples"]
        assert int(f["samples_done"]) == 8
    if kind == "regen":
        assert lanes.shape == (4, 16, 16) and (lanes == 2).all()
        assert rank0["counts"]["simple"]["regen_launches"] > 0
    else:
        assert lanes.shape == (1, 16, 16) and (lanes == 8).all()
    assert float(rank0["wt"].sum()) == 16 * 16 * 16 * 4
    want = _one_process(paths["scene"], 16, simple, env, attrs, monkeypatch=monkeypatch)
    _assert_same((rank0["acc"], rank0["wt"]), want, unit_weights=True)


def test_merge_films_matches_jax():
    """(d) Two partial films made with numpy from a seed: the port's merge at
    world 2 equals the JAX package's merge_films bit for bit."""
    import jax.numpy as jnp
    from pyrite_tpu.parallel import merge_films as jax_merge

    rng = np.random.default_rng(7)
    parts = [tuple((rng.random((16, 16, 8)) * 10.0 ** rng.integers(-3, 4, (16, 16, 8))
                    ).astype(np.float32) for _ in range(2)) for _ in range(2)]
    ranks = _spawn(mesh.merge_parts, 2, (parts,))
    acc_j, wt_j = jax_merge(jnp.stack([p[0] for p in parts]), jnp.stack([p[1] for p in parts]))
    for acc, wt in ranks:
        np.testing.assert_array_equal(acc, np.asarray(acc_j))
        np.testing.assert_array_equal(wt, np.asarray(wt_j))


def test_world_two_film_matches_jax_sharded_statistically(paths, world2, monkeypatch):
    """(e) The port's world-2 film (one-shot, STAT_SPP samples, seed 1)
    against the JAX package's render_sharded on its 8-device CPU mesh
    (regen off, the same samples, seed 1): the JAX test's rule (median
    relative difference of lit pixels < 0.2), and a z-score of the lit
    pixels' mean difference within 4, its standard error from the spread
    of the per-pixel differences (pixels are independent samples)."""
    import jax
    from pyrite_tpu.parallel import make_mesh
    from pyrite_tpu.project import load_project as jax_load
    from pyrite_tpu.renderers import simple as jax_simple
    from pyrite_tpu.scene import build_scene as jax_build

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    monkeypatch.setattr(jax_simple, "regen_enabled", lambda: False)
    pj = jax_load(paths["scene"])
    film, acc, wt = jax_simple.render_sharded(pj, jax_build(pj), make_mesh(jax.devices()[:8]), seed=1,
                                              max_samples=STAT_SPP)
    jax_image = np.asarray(film.develop(acc, wt)).mean(axis=2)
    port = world2["stat"]
    assert float(np.asarray(wt).sum()) == float(port["wt"].sum()) == STAT_SPP * 16 * 16 * 4
    assert port["counts"]["simple"]["regen_launches"] == 0

    from pyrite_tpu_torch.film import Film

    r = load_project(paths["scene"]).project.renderer
    port_image = Film(16, 16, r.spectrum_bins, r.spectrum_span).develop(
        port["acc"], port["wt"]).mean(dim=2).numpy()
    lit = jax_image > 0.05
    assert lit.sum() > 50
    rel = np.abs(jax_image - port_image)[lit] / jax_image[lit]
    assert np.median(rel) < 0.2
    d = (port_image - jax_image)[lit]
    z = d.mean() / (d.std(ddof=1) / np.sqrt(d.size))
    assert abs(z) < 4.0, (f"lit mean {port_image[lit].mean():.5f} against "
                          f"{jax_image[lit].mean():.5f}, z = {z:.2f}")


def test_profile_writes_a_trace_per_rank(world2):
    """--profile on a sharded render: one Chrome trace per rank, named by
    rank."""
    traces = sorted(os.listdir(world2["traces"]))
    assert [t.split("_")[1] for t in traces] == ["rank0", "rank1"], traces
    for name in traces:
        with open(os.path.join(world2["traces"], name)) as fh:
            assert '"traceEvents"' in fh.read()


@pytest.mark.parametrize("how", ["raises", "deadline"])
def test_failing_world_raises_in_the_caller(paths, how):
    """(f) A world whose rank 1 raises (its film is None while rank 0 waits
    in the merge), or whose ranks miss their deadline, ends with an
    exception in the caller, before the deadline; nothing is returned. The
    late world renders a scene of a million pixel samples (test_parallel's
    scene renders its 64 in a fraction of a second once the ranks have
    started), which no host does within its 3 s; it ends in TimeoutError
    whether the deadline finds the ranks starting, joining or rendering."""
    started = time.perf_counter()
    if how == "raises":
        part = (np.ones((4, 4, 2), np.float32), np.ones((4, 4, 2), np.float32))
        with pytest.raises(Exception, match="NoneType|not iterable|process 1"):
            _spawn(mesh.merge_parts, 2, ([part, None],), timeout=60)
        assert time.perf_counter() - started < 60
    else:
        late = os.path.join(paths["dir"], "late.lua")
        with open(late, "w") as fh:
            fh.write(SCENE.replace("pixel_samples = 64,", "pixel_samples = 1000000,"))
        job = _job(dict(paths, late=late), "late", 10**6)
        with pytest.raises(TimeoutError, match="deadline"):
            _spawn(cli.render_ranks, 2, ([job],), timeout=3)
        assert time.perf_counter() - started < 20
