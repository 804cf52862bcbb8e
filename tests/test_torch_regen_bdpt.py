"""The port's camera-regeneration BDPT scheduler on the CPU
(pyrite_tpu_torch/renderers/bidirectional.py, make_regen_launch).

The draws are keyed by (pixel, sample, bounce, purpose), and a regen walk's
lane draws its sample with that sample's keys, against the lamp round the
one-shot step traces for it: so the regen film equals the one-shot film to
summation order. Per case: with the connections and splats switched off
(the camera samples alone) wt equal; the full films wt within rtol 1e-6 and
acc within rtol 1e-4 / atol 1e-6. Cases: a small flagship at 16 + 4
bounces (regen by default), julia (a DE shape) and terrain_24 (the wide
BVH) forced with REGEN_BDPT_MIN_BOUNCES = 1, a 20-bounce lamp budget (one
lamp trace a round), and 40 samples (a 32-sample launch and an 8-sample
one). Also: a sample whose camera position rounds across its pixel's edge
exposes its connections where the one-shot renderer does; compacting every
round (a mirror beside the lamp gives specular lamp vertices) and flushing
every stack (a budget of 1 byte) leave the film as it was to summation
order; a render checkpointed by the CLI after its first launch and resumed
equals the straight one bit for bit. The comparisons with the JAX package
are in tests/test_torch_regen_bdpt_jax.py."""

import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from pyrite_tpu_torch import cli
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import bidirectional as bd
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import build_scene

torch.set_num_threads(2)

SPHERES = """
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 2, 6), to = vector(0, 1, 0)},
    },
    renderer = renderer.bidirectional {
        pixel_samples = 64, spectrum_samples = 4, bounces = 4,
        light_samples = 2, light_bounces = %(lb)d
    },
    world = {
        objects = {
            shape.sphere {
                radius = 50, position = vector(0, -50, 0),
                material = {surface = material.diffuse {color = 0.7}},
            },
            shape.sphere {
                radius = 1, position = vector(0, 3, 0),
                material = {surface = material.emissive {color = 2}},
            },
            shape.sphere {
                radius = 0.8, position = vector(%(x)s, %(y)s, 0),
                material = {surface = %(surface)s},
            },
        },
    },
}
"""


def _spheres(directory, name, w=20, h=20, lb=4, mirror=False):
    """The three-sphere scene of tests/test_torch_bdpt.py; ``mirror``: its
    third sphere a mirror beside the lamp (specular lamp vertices)."""
    path = os.path.join(directory, name + ".lua")
    third = ({"x": "2.2", "y": "3", "surface": "material.mirror {color = 1}"} if mirror else
             {"x": "1.5", "y": "0.8", "surface": "material.diffuse {color = 0.4}"})
    with open(path, "w") as fh:
        fh.write(SPHERES % dict(third, w=w, h=h, lb=lb))
    return path


def _bidirectional(text, bounces, light_bounces):
    return text.replace("renderer.simple", "renderer.bidirectional").replace(
        f"bounces = {bounces},", f"bounces = {bounces}, light_bounces = {light_bounces},", 1)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("regen_bdpt"))
    sys.path.insert(0, chip_smoke.ROOT)
    from __graft_entry__ import _SCENE_SRC
    from tools.synthetic import terrain_scene

    out = {"flagship": os.path.join(directory, "flagship_bdpt_16.lua"),
           "spheres": _spheres(directory, "spheres"),
           "spheres_6": _spheres(directory, "spheres_6", w=6, h=6),
           "deep_light": _spheres(directory, "deep_light", w=12, h=12, lb=20),
           "mirror": _spheres(directory, "mirror", w=16, h=16, lb=4, mirror=True)}
    with open(out["flagship"], "w") as fh:
        fh.write(_bidirectional(_SCENE_SRC % {"w": 16, "h": 8, "s": 4, "b": 16}, 16, 4))
    julia = chip_smoke.write_julia_scene(directory, 6, 4, 4, 2)
    terrain = terrain_scene(directory, cells=24, width=16, height=8, spp=2, bounces=3)[0]
    for name, src, b, lb in (("julia", julia, 2, 1), ("terrain_24", terrain, 3, 3)):
        out[name] = os.path.join(directory, name + "_bdpt.lua")
        with open(src) as fh, open(out[name], "w") as dst:
            dst.write(_bidirectional(fh.read(), b, lb))
    return out


def _forced_regen(m):
    """Regen on any camera budget."""
    m.setattr(bd, "REGEN_BDPT_MIN_BOUNCES", 1)


def _forced_one_shot(m):
    """One-shot on any camera budget."""
    m.setattr(bd, "REGEN_BDPT_MIN_BOUNCES", 10**6)


def _as_it_is(m):
    pass


def _regen_off(m):
    m.setenv("PYRITE_TPU_REGEN", "0")


def _no_splats(scene, film, camera, cfg, conn, wl, acc, wt):
    return acc, wt


def _no_connections(scene, cfg, info, state, conn, conn_vsum, conn_cnt):
    return conn_vsum, conn_cnt


def _render(monkeypatch, path, spp, setup, camera_only=False, seed=5, scene=None):
    """(acc, wt, the counters' increase) of a render after ``setup``(the
    monkeypatch context); ``camera_only``: the connections and splats
    switched off."""
    pd = load_project(path)
    scene = build_scene(pd, "cpu") if scene is None else scene
    with monkeypatch.context() as m:
        setup(m)
        if camera_only:
            m.setattr(bd, "_light_splats", _no_splats)
            m.setattr(bd, "_connect_fold_grouped", _no_connections)
        before = dict(bd.counters)
        _, acc, wt = bd.render(pd, scene, seed=seed, max_samples=spp)
        ran = {k: int(bd.counters[k] - before[k]) for k in before}
    return acc, wt, ran


def _same_film(regen, one_shot):
    assert float(one_shot[1].sum()) > 0
    torch.testing.assert_close(regen[1], one_shot[1], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(regen[0], one_shot[0], rtol=1e-4, atol=1e-6)


def _check_against_one_shot(monkeypatch, path, spp, regen=_forced_regen,
                            one_shot=_forced_one_shot):
    """The camera samples' weights equal, the films to summation order;
    returns the regen render's counters."""
    scene = build_scene(load_project(path), "cpu")
    cam_r = _render(monkeypatch, path, spp, regen, camera_only=True, scene=scene)
    cam_o = _render(monkeypatch, path, spp, one_shot, camera_only=True, scene=scene)
    assert torch.equal(cam_r[1], cam_o[1]) and float(cam_o[1].sum()) > 0
    torch.testing.assert_close(cam_r[0], cam_o[0], rtol=1e-4, atol=1e-6)
    got = _render(monkeypatch, path, spp, regen, scene=scene)
    want = _render(monkeypatch, path, spp, one_shot, scene=scene)
    assert got[2]["regen_bdpt_walks"] > 0 and want[2]["regen_bdpt_walks"] == 0
    _same_film(got, want)
    return got[2]


def test_flagship_16_bounces_takes_regen_and_equals_one_shot(paths, monkeypatch):
    """16 camera bounces take the regen scheduler by default, and
    PYRITE_TPU_REGEN=0 the one-shot step, as in the JAX package."""
    ran = _check_against_one_shot(monkeypatch, paths["flagship"], 3, regen=_as_it_is,
                                  one_shot=_regen_off)
    # 5 lamp slots: all 3 rounds traced in one batch, compacted once
    assert ran["regen_bdpt_launches"] == 1 and ran["regen_bdpt_walks"] == 1 and ran["regen_bdpt_flushes"] == 0
    assert ran["lamp_traces"] == 1 and ran["compactions"] == 1 and ran["steps"] == 0
    assert ran["camera_bounces"] == ran["regen_bdpt_iterations"] > 0


@pytest.mark.parametrize("name", ["julia", "terrain_24"])
def test_forced_regen_equals_one_shot(paths, monkeypatch, name):
    _check_against_one_shot(monkeypatch, paths[name], 2)


def test_deep_light_traces_a_round_at_a_time(paths, monkeypatch):
    ran = _check_against_one_shot(monkeypatch, paths["deep_light"], 3)
    assert ran["lamp_traces"] == 3 and ran["compactions"] == 3


def test_two_launches_equal_one_shot(paths, monkeypatch):
    """max_samples = 40: a launch of 32 samples, then one of 8."""
    ran = _check_against_one_shot(monkeypatch, paths["spheres_6"], 40)
    assert ran["regen_bdpt_launches"] == 2 and ran["regen_bdpt_walks"] == 2


def test_connections_land_where_one_shot_exposes_them(paths, monkeypatch):
    """Camera positions moved half a pixel: the connection sums of half
    the samples belong to the next pixel (expose_sums, one-shot) or off the
    film, while the camera samples stay at the lane's pixel."""
    real = simple.camera_rays

    def shifted(film, camera, s, pixel, u):
        positions, origin, direction, wavelengths = real(film, camera, s, pixel, u)
        step = torch.tensor([1.0 / max(film.width, film.height), 0.0])
        return positions + step, origin, direction, wavelengths

    path = paths["spheres"]
    plain = _render(monkeypatch, path, 2, _forced_regen)
    monkeypatch.setattr(simple, "camera_rays", shifted)
    monkeypatch.setattr(bd, "camera_rays", shifted)
    regen = _render(monkeypatch, path, 2, _forced_regen)
    _same_film(regen, _render(monkeypatch, path, 2, _forced_one_shot))
    assert not torch.equal(regen[1], plain[1])
    assert regen[2]["regen_bdpt_stray_scatters"] > 0


def test_compacting_every_round_leaves_the_film(paths, monkeypatch):
    """At 4 lamp bounces (5 slots) every round is compacted to its
    connectable slots: the mirror's specular vertices move the connectable
    slots after them forward. The film equals the one with every slot kept
    in place."""
    moved = []
    real = bd._compact_connections

    def spy(conn, k):
        out = real(conn, k)
        moved.append(not torch.equal(out["conn_ok"], conn["conn_ok"][:, :k]))
        return out

    path = paths["mirror"]
    monkeypatch.setattr(bd, "_compact_connections", spy)
    compacted = _render(monkeypatch, path, 3, _forced_regen)
    assert compacted[2]["compactions"] == 1 and moved == [True]
    monkeypatch.setattr(bd, "_compact_connections", lambda conn, k: conn)
    full = _render(monkeypatch, path, 3, _forced_regen)
    torch.testing.assert_close(compacted[1], full[1], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(compacted[0], full[0], rtol=1e-5, atol=1e-6)
    assert float(full[1].sum()) > 0


def test_flushing_every_round_leaves_the_film(paths, monkeypatch):
    path = paths["deep_light"]
    whole = _render(monkeypatch, path, 3, _forced_regen)
    monkeypatch.setattr(bd, "_CONN_STACK_BYTES", 1)
    flushed = _render(monkeypatch, path, 3, _forced_regen)
    assert whole[2]["regen_bdpt_flushes"] == 0 and whole[2]["regen_bdpt_walks"] == 1
    assert flushed[2]["regen_bdpt_flushes"] == 2 and flushed[2]["regen_bdpt_walks"] == 3
    torch.testing.assert_close(flushed[1], whole[1], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(flushed[0], whole[0], rtol=1e-5, atol=1e-6)


class _Stop(Exception):
    pass


def _cli(monkeypatch, path, *args, stop_after=None):
    """cli.main on the CPU; returns (acc, wt) of its render. ``stop_after``
    n: raise after the n-th progress callback (its checkpoint is written)."""
    render = bd.render
    seen = {"calls": 0}

    def recording(*a, on_progress=None, **k):
        def progress(p):
            on_progress(p)
            seen["calls"] += 1
            if seen["calls"] == stop_after:
                raise _Stop

        film, acc, wt = render(*a, on_progress=progress, **k)
        seen["film"] = (acc.clone(), wt.clone())
        return film, acc, wt

    with monkeypatch.context() as m:
        m.setattr(bd, "render", recording)
        out = os.path.join(os.path.dirname(path), "out.png")
        assert cli.main([path, "--device", "cpu", "--output", out, "--preview-interval", "0",
                         *args]) == 0
    return seen["film"]


def test_resumed_render_equals_straight(paths, tmp_path, monkeypatch):
    """Launches of 2 samples; a checkpoint after the first, resumed."""
    monkeypatch.setattr(bd, "REGEN_BDPT_SPP_CHUNK", 2)
    path = paths["flagship"]
    before = bd.counters["regen_bdpt_launches"]
    straight = _cli(monkeypatch, path, "--samples", "4")
    assert bd.counters["regen_bdpt_launches"] - before == 2
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(_Stop):
        _cli(monkeypatch, path, "--samples", "4", "--checkpoint", ck, stop_after=1)
    with np.load(ck) as f:
        assert int(f["samples_done"]) == 2 and f["lane_samples"].min() == 2
    resumed = _cli(monkeypatch, path, "--samples", "4", "--checkpoint", ck)
    assert torch.equal(resumed[1], straight[1]) and torch.equal(resumed[0], straight[0])
    assert float(straight[1].sum()) > 0
