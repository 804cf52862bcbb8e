"""Smoke check of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives pyrite_tpu_torch's paths (``.lua`` -> PNG through the CUDA bounce
and NEE kernels, on dense scenes, on scenes of distance-estimated (DE)
shapes and on mesh scenes; the mesh ray queries; the DE march) on the card
and exits non-zero on any failure:

1. device: the card's name, power limit and maximum SM clock;
2. build: the kernels, from the sources, into an empty build directory;
3. kernels against their plain PyTorch version on the card, at the
   wavefront the main path launches: the keyed draw kernel (Philox4x32-10)
   bit for bit against rng.py on the card and on the CPU, on flagship and
   fractal.lua, in its affine mode (the one-shot wavefront) and its indexed
   mode (random pixels, samples and depths at the regeneration width, as a
   regeneration iteration and the survivor pool draw); the DE march kernel (a persistent pass
   that refills a lane as its ray ends) on the camera rays of
   examples/fractal.lua (a Mandelbulb in a box), of the julia scene (a cubic
   quaternion Julia in a sphere, no finite primitive), of terrain_de_24 (a
   mesh with a Mandelbulb) and of two_de (a Mandelbulb and a cubic Julia),
   as the query and as the bounce march pass, and over their bounce-0 NEE
   shadow rays as the shadow march pass, bit for bit, with the SIMT
   efficiency the in-thread march had on those rays; the dense bounce and
   NEE kernels on four dense scenes (flagship spheres, examples/prism.lua, a
   triangle-lamp mesh, a many-materials scene) and on the DE scenes, with no
   divergent lane; the
   wide-BVH traversal kernels on the 328,050- and 871,200-triangle terrains
   (tools/synthetic.terrain_scene, cells 405 and 660), bit for bit; the wide
   bounce and NEE kernels on terrain_405 and terrain_de_24; the kProg
   instantiations (textures, normal maps, programs that read the ray) on
   the textures scenes of texture_paths, dense and wide (515 primitives)
   and with textures of a user's size (textures_1k),
   against the same geometry untextured, with no divergent lane;
4. per-launch times of the kernels and of the plain version at that size
   (the traversal queries on both terrains and the wide kernels on
   terrain_405 at bounces 0 and 1; the dense kernels and the draw kernel on
   flagship; the kProg kernels on textures, textures_512 and textures_1k
   (with texture taps per lane) beside the
   simple ones on untextured; on fractal.lua the march passes and the bounce and NEE kernels
   apart at bounces 0 and 1, and the march query with its issue-based bound
   from the SASS of one estimator iteration), with the work the plain
   version counts, from which each kernel's bound is computed, and the
   warps' divergence in the traversal; for the dense bounce and NEE kernels
   also their occupancy, copy-only probes of their memory traffic, and per
   warp the branches taken and the DE hits' normal probes, with the
   issue-based bound of those probes (measure_rows);
5. the schedulers and the paths. The same render through the one-shot
   wavefront, path regeneration and the survivor pool, on flagship and
   terrain_24 at 4 spp: wt equal, acc within rtol 1e-4 (the keyed draws
   make them trace the same paths). Then each path with the launch counts
   zeroed just before it and read just after: the CLI renders, through
   regeneration (the default), the flagship and prism.lua (dense kernels),
   fractal.lua and the julia scene (per iteration a march pass, the dense
   bounce kernel, a shadow march pass, the dense NEE kernel), terrain_405
   (wide bounce and NEE kernels), and prism.lua again through the survivor
   pool (regeneration off), every render drawing its random numbers
   through the draw kernel (one launch per regeneration iteration) and
   printing its live and executed lane-bounces and peak memory; the ray
   queries closest_wide / shadow_wide trace one step's camera rays of
   terrain_405 and their shadow rays (wide traversal kernels); the textures
   scene (through regeneration and one-shot) and textures_512 render
   through the kProg kernels, each render printing the bytes a lane of its
   wavefront took;
   kernels.march_de marches one step's camera rays of fractal.lua (DE march
   kernel). No bounce may take the plain path.
6. the bidirectional renderer (renderers/bidirectional.py) on
   cornell_class (write_cornell_scene: the reference workload's 512 x 512,
   4 + 4 bounces, S = 10, 50 bins over a Cornell-class box with a triangle
   lamp, dispersive glass and a quaternion Julia), flagship_bdpt (the
   flagship with renderer.bidirectional, 8 + 8 bounces; and at
   light_bounces = 24, the two-phase step) and terrain_405_bdpt (the wide
   kernels): its kernels against their plain versions at a render's
   wavefront (check_bdpt: the lamp kernel, the bounce kernel's kRecord
   instantiation and, bit for bit, dense_shadow_kernel on the connection
   and splat batches), their times and bounds (time_bdpt), a 64 x 64
   Cornell render through the kernels against one through the plain
   versions on the card (compare_bdpt_plain), and the four renders through
   the CLI with the counts zeroed just before each (render_bdpt); then the
   textures BDPT scene at flagship_bdpt's size: the kProg A and B and
   program_colors_kernel (the lamp vertices' colours) against their plain
   versions, timed beside A and B on its untextured twin, and rendered
   through the CLI. Then the regen BDPT step (regen_bdpt_step):
   flagship_bdpt_deep (the flagship at 16 + 8 bounces, which takes the
   camera-regeneration scheduler) at 4 spp through regen and through
   one-shot, the films to the CPU tests' tolerance, with A, the NEE kernel
   and C held to their plain versions at the first regen iteration where
   regenerated lanes and lanes at depth >= 1 coexist (regen_probe); then
   four CLI renders through regen with the counts zeroed just before each:
   flagship_bdpt_deep, and with REGEN_BDPT_MIN_BOUNCES = 1 the 64 x 64
   Cornell class (the DE march), terrain_405_bdpt (the wide kernels) and
   flagship_bdpt_24 (a lamp trace a round). No step may take the plain
   path.
7. the photon renderer (renderers/photon.py) on flagship_photon (the
   flagship as a photon project at 512 x 256, S = 6, 8 bounces; 100,000
   photons of 8 bounces in 2 passes, radius 0.1; exact mode) and
   textures_photon (the textures scene as a photon project: interpolation
   mode, 70-column camera rows through the kProg kernels), and
   flagship_photon_512 (the same at 512 film bins): photon_gather_kernel
   against its plain version on the hand-built edge maps of
   gather_edge_maps (check_gather_edges), then the bounce kernels' chain
   factors and the gather against their plain versions at the wavefront
   render() launches (check_photon, printing the bins bit-equal to the
   plain version's), the gather's time and bound (time_photon), and a CLI
   render of each with the counts zeroed just before it (render_photon),
   printing its maps' cell occupancy.

8. multi-device on one card (multi_device_step): two ranks share cuda:0
   over gloo through parallel.spawn and cli.render_ranks (the CLI's
   --multi-device path but for its device count and backend) and render
   the flagship at 4 spp through regeneration and one-shot,
   flagship_bdpt_deep at 4 spp through regen BDPT and flagship_photon at 2
   spp; each merged film against the one-process film of the same render
   (wt equal for the simple renderer, else within rtol 1e-6; acc within
   rtol 1e-4), every rank's kernel launches positive and its plain counts
   zero, its wall and peak memory and the merges' bytes and ms a call (not
   a scaling figure: both ranks on one card, the merge through the host).

10. the gate's last refusals (gate_last_step): a scene of planes alone, a
   textures scene whose colour program needs 80 values in the expression's
   order (lowered in Sethi-Ullman order), 2,411 DE shapes (march_de_kernel
   reads each from the sheet) and flagship_photon at 7,086 and 10,000 film
   bins (photon_gather_kernel's <out_row> form): each changed kernel against
   its plain version at a small wavefront, each new form against its parent
   form at a size both run, bit for bit, then the CLI renders.

The rest of the scene gate (gate_paths: directional lamps, S = 24, 32 and
64, 300 materials through the baked colour table, 150 lamps and 130
planes, an 82-instruction program at stack depth 12, 130 DE shapes) runs
through phases 3-5 after the textures scenes (check_gate: the draw kernel
at S = 32 and 64 bit for bit, the bounce and NEE kernels against the plain
version with no divergent lane, their times and bounds, CLI renders with
the peak memory beside a build without the table) and phase 6 after the
textures BDPT scene (check_gate_bdpt).

The last line is one JSON object {"ok": true, "device": {...}}; the line
before it lists each kernel's launches, error, times and bound.

The main run builds the kernels from clean; the modes below reuse a build
of the same sources where there is one.
``python3 chip_smoke.py --rows [PARENT_CSRC [OUT.json]]`` instead runs phase 4's
measurements of the dense bounce and NEE kernels alone (measure_rows), the
textures scene's bounce and NEE kernel times, kernels A and D alone
(measure_record_rows: each form of A in RECORD_FORMS at camera bounces 0
and 1, D on textures_bdpt's lamp vertices and on color_edge_batches,
through this build, the probes of RECORD_VARIANTS and, given PARENT_CSRC,
a parent checkout's csrc/ built beside it, in the order parent, build,
probes, build, parent on the same inputs, with each output's digest
against the parent's; OUT.json keeps every number), and last
materials_300 read from its baked colour table against the per-launch
bank (measure_bank). ``--record-rows [PARENT_CSRC [OUT.json]]`` runs
measure_record_rows alone. ``--prog`` runs the measurements of the kProg
instantiations, with builds of csrc/bounce.cu that each remove or move one
cost (measure_prog).
``python3 chip_smoke.py --gate-last [PARENT_CSRC [OUT.json]]`` times phase
10's new forms against their parent forms at a size both run
(measure_gate_last: the march passes at 1, 130 and 2,410 DE shapes, the gather
at 7,085 bins, the kProg bounce and NEE kernels at stacks 8 and 48),
given PARENT_CSRC also through a parent checkout's csrc/ built beside this
build, in the order parent, build, build, parent.
``python3 chip_smoke.py --photon`` runs phase 7's gather alone
(photon_step: check_photon and time_photon on flagship_photon and
textures_photon, then profile_photon's 2-spp walls).
``python3 chip_smoke.py --multi`` runs phase 8 alone, then cards_probe on
two ranks sharing cuda:0; ``--cards``, on a machine with several cards, the
same with one rank a card over NCCL and more samples, then the CLI's
``--multi-device`` (multi_card_step) and cards_probe over the cards.
``python3 chip_smoke.py --walls`` instead runs ``--profile``'s flagship
renders alone (one-shot and regeneration walls); ``--regen`` phase 6's
regen BDPT step alone (regen_bdpt_step), then ``--profile``'s
flagship_bdpt_deep, flagship_bdpt_64 and flagship_bdpt_256 renders (regen
and one-shot walls at 16, 64 and 256 camera bounces, and their ratio).
``python3 chip_smoke.py --profile`` instead renders the main-path scenes
(flagship and terrain_405 at 64 spp, fractal.lua at 8 spp) through
renderers.simple.render under the one-shot wavefront and under
regeneration, and the bidirectional scenes of phase 6 through
renderers.bidirectional.render (profile_bdpt) and flagship_photon through
renderers.photon.render (profile_photon), 5 timed runs after a
warm-up and one run under torch.profiler, and prints the launches,
lane-bounces, peak memory, wall times, device idle share and top device ops
of each. Both modes print each kernel's registers and
spills (ptxas -v) after the build.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

TRI_LAMP_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 6, -4), to = vector(0, 0, 10)},
    },
    renderer = renderer.simple {
        pixel_samples = 256,
        spectrum_samples = %(s)d,
        light_samples = 2,
        bounces = %(b)d,
    },
    world = {
        sky = 0.05,
        objects = {
            shape.mesh {
                file = "lamp_quad.obj", materials = {
                    lamp = {surface = material.emissive {color = light_source.d65 * 6}},
                },
            },
            shape.mesh {
                file = "terrain_%(cells)d.obj", materials = {
                    terrain = {surface = material.diffuse {color = rgb(0.7, 0.6, 0.5)}},
                },
            },
        },
    },
}
"""

LAMP_QUAD_OBJ = """o lamp
v -2 5 8
v 2 5 8
v 2 5 12
v -2 5 12
f 1 2 3
f 1 3 4
"""


def write_tri_lamp_scene(directory, width=64, height=32, spectrum_samples=4, bounces=4, cells=5):
    """A triangle-lamp scene: a two-triangle emissive quad over a
    2 * cells^2-triangle heightfield (tools/synthetic.terrain_obj; 5 cells
    make a dense scene of 52 triangles, 24 cells a mesh scene of 1154).
    Returns the .lua path."""
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_obj

    with open(os.path.join(directory, "lamp_quad.obj"), "w") as fh:
        fh.write(LAMP_QUAD_OBJ)
    terrain_obj(os.path.join(directory, f"terrain_{cells}.obj"), cells=cells)
    path = os.path.join(directory, "tri_lamp.lua" if cells == 5 else f"tri_lamp_{cells}.lua")
    with open(path, "w") as fh:
        fh.write(TRI_LAMP_SCENE % {
            "w": width, "h": height, "s": spectrum_samples, "b": bounces, "cells": cells})
    return path


MANY_MATERIALS_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 50,
        transform = transform.look_at {from = vector(0, 2.5, 0), to = vector(0, 0.5, 6)},
    },
    renderer = renderer.simple {
        pixel_samples = 256,
        spectrum_samples = %(s)d,
        light_samples = 2,
        bounces = %(b)d,
    },
    world = {
        sky = 0.2,
        objects = {
            shape.plane {
                origin = vector(0, 0, 0), normal = vector(0, 1, 0),
                material = {surface = material.diffuse {color = 0.5}},
            },
            shape.sphere {
                radius = 0.6, position = vector(0, 3, 7),
                material = {surface = material.emissive {color = light_source.d65 * 5}},
            },
%(balls)s
        },
    },
}
"""


def write_many_materials_scene(directory, width=64, height=32, spectrum_samples=4, bounces=4):
    """Nine diffuse balls of distinct RGB colors over a plane under a sphere
    lamp: eleven wavelength-only color programs, enough for the program
    bank tables (scene.bake_bank_tables). Returns the .lua path."""
    balls = []
    for i in range(9):
        rgb = ((i * 0.37) % 1.0, (0.2 + i * 0.61) % 1.0, (0.9 - i * 0.23) % 1.0)
        balls.append(
            f"            shape.sphere {{radius = 0.4, position = vector({(i % 3 - 1) * 1.1}, 0.4, "
            f"{5 + i // 3 * 1.1}), material = {{surface = material.diffuse {{color = "
            f"rgb({rgb[0]:.3f}, {rgb[1]:.3f}, {rgb[2]:.3f})}}}}}},"
        )
    path = os.path.join(directory, "many_materials.lua")
    with open(path, "w") as fh:
        fh.write(MANY_MATERIALS_SCENE % {
            "w": width, "h": height, "s": spectrum_samples, "b": bounces, "balls": "\n".join(balls)})
    return path


def scene_paths(directory, width=64, height=32, spectrum_samples=4, bounces=4):
    """The dense scenes the port is held to: the flagship spheres scene
    (__graft_entry__._SCENE_SRC) at the given size, examples/prism.lua (a
    plane, a point lamp, one spectrum sample), the triangle-lamp mesh and the
    many-materials scene (program bank tables). Returns {name: .lua path}."""
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _SCENE_SRC

    flagship = os.path.join(directory, "flagship.lua")
    with open(flagship, "w") as fh:
        fh.write(_SCENE_SRC % {"w": width, "h": height, "s": spectrum_samples, "b": bounces})
    return {
        "flagship": flagship,
        "prism": os.path.join(ROOT, "examples", "prism.lua"),
        "tri_lamp": write_tri_lamp_scene(directory, width, height, spectrum_samples, bounces),
        "many_materials": write_many_materials_scene(
            directory, width, height, spectrum_samples, bounces
        ),
    }


JULIA_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    renderer = renderer.simple {
        pixel_samples = 64,
        spectrum_samples = %(s)d,
        bounces = %(b)d,
        light_samples = 1,
    },
    camera = camera.perspective {
        fov = 40,
        transform = transform.look_at {from = vector(0.4, 0.9, -3.4), to = vector(0, -0.2, 0)},
    },
    world = {
        sky = 0.05,
        objects = {
            shape.ray_marched {
                shape = ray_marched.quaternion_julia {
                    iterations = 25,
                    threshold = 4,
                    constant = vector(-0.45, -0.0375, -0.4, -0.025),
                    slice_plane = 0,
                    variant = quaternion_julia.cubic,
                },
                bounds = {type = "sphere", position = vector(0, 0, 0), radius = 1.5},
                material = {surface = material.diffuse {color = rgb(0.8, 0.55, 0.35)}},
            },
            shape.plane {
                origin = vector(0, -1.3, 0), normal = vector(0, 1, 0),
                material = {surface = material.diffuse {color = 0.6}},
            },
            light.point {position = vector(2, 4, -3), color = light_source.d65 * 60},
        },
    },
}
"""


def write_julia_scene(directory, width=256, height=256, spectrum_samples=4, bounces=4):
    """The julia scene: the cubic quaternion Julia that tools/tpu_de_bench.py
    names as cornell's (25 iterations, constant (-0.45, -0.0375, -0.4,
    -0.025), slice 0) in a bounding sphere, over a diffuse plane floor, lit
    by a point lamp; no finite primitive. Returns the .lua path."""
    path = os.path.join(directory, "julia.lua")
    with open(path, "w") as fh:
        fh.write(JULIA_SCENE % {"w": width, "h": height, "s": spectrum_samples, "b": bounces})
    return path


CORNELL_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    renderer = renderer.bidirectional {
        pixel_samples = %(spp)d,
        spectrum_samples = %(s)d,
        spectrum_resolution = 50,
        bounces = %(b)d,
        light_bounces = %(lb)d,
        light_samples = 1,
    },
    camera = camera.perspective {
        fov = 40,
        transform = transform.look_at {from = vector(0, 3, -10.5), to = vector(0, 3, 0)},
    },
    world = {
        objects = {
            shape.mesh {
                file = "cornell_box.obj", materials = {
                    white = {surface = material.diffuse {color = 0.75}},
                    red = {surface = material.diffuse {color = rgb(0.7, 0.1, 0.1)}},
                    green = {surface = material.diffuse {color = rgb(0.1, 0.6, 0.15)}},
                    lamp = {surface = material.emissive {color = light_source.d65 * 10}},
                },
            },
            shape.sphere {
                radius = 0.9, position = vector(-1.4, 0.9, -0.6),
                material = {surface = material.refractive {ior = 1.5, dispersion = 0.01, color = 1}},
            },
            shape.ray_marched {
                shape = ray_marched.quaternion_julia {
                    iterations = 25,
                    threshold = 4,
                    constant = vector(-0.45, -0.0375, -0.4, -0.025),
                    slice_plane = 0,
                    variant = quaternion_julia.cubic,
                },
                bounds = {type = "sphere", position = vector(1.3, 1.5, 0.9), radius = 1.5},
                material = {surface = material.diffuse {color = rgb(0.8, 0.55, 0.35)}},
            },
        },
    },
}
"""


def _cornell_obj():
    """The box's OBJ text: five walls of 6 x 6 (x in [-3, 3], y in [0, 6],
    z in [-3, 3], open toward the camera at z = -3; the red wall at x = 3,
    on the camera's left) and a 1.8 x 1.8 lamp
    quad just under the ceiling, two triangles each, wound so that each
    face's normal (e1 x e2) points into the box."""
    import numpy as np

    quads = [  # (object, corners, inward normal)
        ("white", [(-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)], (0, 1, 0)),
        ("white", [(-3, 6, -3), (3, 6, -3), (3, 6, 3), (-3, 6, 3)], (0, -1, 0)),
        ("white", [(-3, 0, 3), (3, 0, 3), (3, 6, 3), (-3, 6, 3)], (0, 0, -1)),
        ("green", [(-3, 0, -3), (-3, 0, 3), (-3, 6, 3), (-3, 6, -3)], (1, 0, 0)),
        ("red", [(3, 0, -3), (3, 0, 3), (3, 6, 3), (3, 6, -3)], (-1, 0, 0)),
        ("lamp", [(-0.9, 5.98, -0.9), (0.9, 5.98, -0.9), (0.9, 5.98, 0.9), (-0.9, 5.98, 0.9)],
         (0, -1, 0)),
    ]
    lines, count = [], 0
    for name, corners, inward in quads:
        c = np.asarray(corners, np.float64)
        if np.dot(np.cross(c[1] - c[0], c[2] - c[0]), inward) < 0:
            c = c[::-1]
        lines.append(f"o {name}")
        lines += [f"v {x:g} {y:g} {z:g}" for x, y, z in c]
        lines += [f"f {count + 1} {count + 2} {count + 3}", f"f {count + 1} {count + 3} {count + 4}"]
        count += 4
    return "\n".join(lines) + "\n"


def write_cornell_scene(directory, width=512, height=512, spectrum_samples=10, bounces=4,
                        light_bounces=4, spp=64):
    """cornell_class, the reference's own workload at its published
    settings (SURVEY.md section 6, test/cornell/cornell.lua:17-27: BDPT,
    512 x 512, 4 + 4 bounces, 10 spectrum samples, 50 bins) over an
    in-repo Cornell-class box: five diffuse walls as triangles (white, red,
    green), a triangle-quad ceiling lamp, a dispersive glass sphere and the
    julia scene's cubic quaternion Julia; a dense scene of 12 triangles, a
    sphere and one DE shape. Returns the .lua path."""
    with open(os.path.join(directory, "cornell_box.obj"), "w") as fh:
        fh.write(_cornell_obj())
    path = os.path.join(directory, "cornell.lua")
    with open(path, "w") as fh:
        fh.write(CORNELL_SCENE % {"w": width, "h": height, "s": spectrum_samples, "b": bounces,
                                  "lb": light_bounces, "spp": spp})
    return path


def write_fractal_scene(directory, width=512, height=512, spectrum_samples=8, bounces=6):
    """examples/fractal.lua (a power-8 Mandelbulb of 12 iterations in a box,
    a mirror/diffuse fresnel mix, a blackbody sphere lamp) with its image
    size, spectrum samples and bounces replaced. Returns the .lua path."""
    with open(os.path.join(ROOT, "examples", "fractal.lua")) as fh:
        src = fh.read()
    for key, value in (("width", width), ("height", height),
                       ("spectrum_samples", spectrum_samples), ("bounces", bounces)):
        src, count = re.subn(rf"\b{key} = \d+", f"{key} = {value}", src, count=1)
        assert count == 1, key
    path = os.path.join(directory, f"fractal_{width}x{height}.lua")
    with open(path, "w") as fh:
        fh.write(src)
    return path


TERRAIN_DE_OBJECT = """
            shape.ray_marched {
                shape = ray_marched.mandelbulb {iterations = 8, threshold = 4, power = 8},
                bounds = bounds.box {min = vector(-1.3, 2.2, 6.7), max = vector(1.3, 4.8, 9.3)},
                material = {surface = material.diffuse {color = rgb(0.3, 0.5, 0.8)}},
            },
        },
    },
}
"""


def write_terrain_de_scene(directory, cells=24, width=48, height=24, spp=2, bounces=4):
    """A mesh scene with a DE shape: tools/synthetic.terrain_scene with a
    small Mandelbulb (8 iterations, power 8) hanging above the terrain.
    Returns the .lua path."""
    path = terrain_paths(directory, cells=(cells,), width=width, height=height, spp=spp,
                         bounces=bounces)[f"terrain_{cells}"]
    with open(path) as fh:
        src = fh.read()
    head, tail = src.rsplit("        },\n    },\n}", 1)
    assert not tail.strip(), tail
    de_path = os.path.join(directory, f"terrain_de_{cells}.lua")
    with open(de_path, "w") as fh:
        fh.write(head + TERRAIN_DE_OBJECT.lstrip("\n"))
    return de_path


TWO_DE_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    renderer = renderer.simple {
        pixel_samples = 64,
        spectrum_samples = %(s)d,
        bounces = %(b)d,
        light_samples = 2,
    },
    camera = camera.perspective {
        fov = 50,
        transform = transform.look_at {from = vector(0.2, 1.4, -5), to = vector(0, -0.2, 0)},
    },
    world = {
        sky = 0.05,
        objects = {
            shape.ray_marched {
                shape = ray_marched.mandelbulb {iterations = 10, threshold = 4, power = 8},
                bounds = bounds.box {min = vector(-2.5, -1.2, -1.2), max = vector(-0.1, 1.2, 1.2)},
                material = {surface = material.diffuse {color = rgb(0.3, 0.5, 0.8)}},
            },
            shape.ray_marched {
                shape = ray_marched.quaternion_julia {
                    iterations = 25,
                    threshold = 4,
                    constant = vector(-0.45, -0.0375, -0.4, -0.025),
                    slice_plane = 0,
                    variant = quaternion_julia.cubic,
                },
                bounds = {type = "sphere", position = vector(1.3, 0, 0), radius = 1.4},
                material = {surface = material.diffuse {color = rgb(0.8, 0.55, 0.35)}},
            },
            shape.plane {
                origin = vector(0, 1.3, 0), normal = vector(0, 1, 0),
                material = {surface = material.diffuse {color = 0.6}},
            },
            shape.sphere {
                position = vector(2, 4, -3), radius = 0.5,
                material = {surface = material.emissive {color = light_source.d65 * 20}},
            },
        },
    },
}
"""


def write_two_de_scene(directory, width=128, height=64, spectrum_samples=4, bounces=4):
    """Two DE shapes of different kinds side by side: a Mandelbulb (10
    iterations) in a box and the julia scene's cubic quaternion Julia in a
    sphere, over a diffuse floor at y = -1.3 (the scene builder mirrors a
    plane through the world origin, as the reference does), lit by a sphere
    lamp. A march pass orders
    its items shape by shape, so the warps at the border between the two
    shapes march both kinds. Returns the .lua path."""
    path = os.path.join(directory, "two_de.lua")
    with open(path, "w") as fh:
        fh.write(TWO_DE_SCENE % {"w": width, "h": height, "s": spectrum_samples, "b": bounces})
    return path


TEXTURES_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 55,
        transform = transform.look_at {from = vector(0, 2.2, -5), to = vector(0, 0.6, 2)},
    },
    renderer = renderer.%(renderer)s {
        pixel_samples = %(spp)d,
        spectrum_samples = %(s)d,
        light_samples = 1,
        bounces = %(b)d,%(extra)s
    },
    world = {
        sky = %(sky)s,
        objects = {
            shape.plane {
                origin = vector(0, -0.5, 0), normal = vector(0, 1, 0), texture_scale = 5,
                material = {
                    surface = material.diffuse {color = %(checker)s},
                    normal_map = %(bumps)s,
                },
            },
            shape.sphere {
                position = vector(-1.3, 0.5, 2), radius = 1, texture_scale = vector(0.5, 1.0),
                material = {
                    surface = material.diffuse {color = rgb(0.8, 0.7, 0.6)},
                    normal_map = %(bumps)s,
                },
            },
            shape.sphere {
                position = vector(1.4, 0.4, 2.5), radius = 0.9,
                material = {surface = material.diffuse {color = %(fresnel)s}},
            },
            shape.mesh {
                file = "%(obj)s", materials = {
                    tiles = {surface = mix(material.diffuse {color = %(checker)s},
                                           material.mirror {color = 0.9}, %(mask)s)},
                },
            },
            shape.sphere {
                position = vector(0, 3.2, 2.5), radius = 0.6, texture_scale = vector(0.5, 1.0),
                material = {surface = material.emissive {color = light_source.d65 * %(lamp)s * 4}},
            },
        },
    },
}
"""
# The textures scene's expressions that read the ray, and the constants of
# its untextured twin (the same geometry, the simple kernels' form).
TEXTURED = {
    "sky": 'mix(0.03, texture("sky.png", "mono"), fresnel(1.33))',
    "checker": 'texture("checker.png")',
    "bumps": 'texture("bumps.png", "linear") * vector(1, -1, 1)',
    "fresnel": "rgb(0.9, 0.75, 0.3) * fresnel(1.8)",
    "mask": 'texture("mask.png", "mono")',
    "lamp": 'texture("lamp.png")',
}
UNTEXTURED = {"sky": "0.1", "checker": "rgb(0.6, 0.5, 0.4)", "bumps": "nil",
              "fresnel": "rgb(0.9, 0.75, 0.3)", "mask": "0.5", "lamp": "rgb(1, 0.9, 0.8)"}


def deep_expression(core, chain=8, nest=9, subtract=False):
    """A colour expression past the old program form's limits around
    ``core`` (an rgb expression that reads the ray): ``chain`` steps of
    (x * 1.01 - 0.005) that keep the stack shallow and lengthen the code,
    under ``nest`` levels of (0.004 + (...)) that each hold one more value
    on the stack, with ``subtract`` every second one (1.004 - (...)), whose
    operands Sethi-Ullman order takes reversed (a SWAP). The textures
    scene's fresnel colour so wrapped (textures_deep) lowers to 82
    instructions at stack depth 12 (exprs.KernelPrograms)."""
    expr = core
    for _ in range(chain):
        expr = f"({expr} * 1.01 - 0.005)"
    for level in range(nest):
        expr = f"(1.004 - {expr})" if subtract and level % 2 else f"(0.004 + {expr})"
    return expr


# the textures scene with its fresnel sphere's colour past 64 instructions
# and a stack of 8 values (the kProg kernels' program stack sized by it)
DEEP = dict(TEXTURED, fresnel=deep_expression(TEXTURED["fresnel"]))


def _tiles_obj(cols, rows):
    """A grid of cols x rows quads on a wall behind the scene (z = 5, x in
    [-3, 3], y in [-0.5, 3]), two triangles each, with vt running from 0 to
    2.5 across it (past 1: the textures wrap) and no vn (face normals)."""
    lines = ["o tiles"]
    for j in range(rows + 1):
        for i in range(cols + 1):
            lines.append(f"v {-3 + 6 * i / cols:.5f} {-0.5 + 3.5 * j / rows:.5f} 5")
            lines.append(f"vt {2.5 * i / cols:.5f} {2.5 * j / rows:.5f}")
    for j in range(rows):
        for i in range(cols):
            a = j * (cols + 1) + i + 1
            b, d = a + 1, a + cols + 1
            c = d + 1
            lines.append(f"f {a}/{a} {c}/{c} {b}/{b}")
            lines.append(f"f {a}/{a} {d}/{d} {c}/{c}")
    return "\n".join(lines) + "\n"


def write_texture_images(directory, seed=3, size=None):
    """The textures scene's images, written with the port's PNG writer
    (film.save_png) from a numpy seed, none square and none a power of two:
    checker.png 37 x 23 (sRGB colours), bumps.png 29 x 41 (a linear normal
    map around (0.5, 0.5, 1)), mask.png 19 x 13, sky.png 11 x 7 and lamp.png
    23 x 17 (read as mono or colour). With ``size`` the checker and the
    normal map are size x size and the mask size / 2 on a side, as a user's
    textures are."""
    import numpy as np

    from pyrite_tpu_torch.film import save_png

    rng = np.random.default_rng(seed)
    (ch, cw), (bh, bw), (mh, mw) = ((size, size), (size, size), (size // 2, size // 2)) if size \
        else ((23, 37), (41, 29), (13, 19))
    y, x = np.mgrid[0:ch, 0:cw]
    checker = np.where(((x // 4 + y // 3) % 2)[..., None] == 1, [200, 60, 40], [40, 90, 200])
    checker = checker + rng.integers(0, 40, (ch, cw, 3))
    bumps = np.empty((bh, bw, 3))
    bumps[..., :2] = 0.5 + 0.35 * rng.uniform(-1, 1, (bh, bw, 2))
    bumps[..., 2] = 1.0
    images = {
        "checker.png": checker,
        "bumps.png": bumps * 255,
        "mask.png": rng.integers(0, 256, (mh, mw, 1)).repeat(3, axis=2),
        "sky.png": rng.integers(0, 256, (7, 11, 3)),
        "lamp.png": 128 + rng.integers(0, 128, (17, 23, 3)),
    }
    for name, image in images.items():
        save_png(os.path.join(directory, name), np.clip(image, 0, 255).astype(np.uint8))


def write_textures_scene(directory, width=64, height=48, spectrum_samples=4, bounces=4, spp=64,
                         renderer="simple", light_bounces=4, textured=True, tiles=(3, 2),
                         texture_size=None, deep=False, photon=None):
    """The textures class of the reference's golden scenes (SURVEY.md
    section 6: bicubic colour and normal maps with texture_scale): a plane
    with texture_scale = 5, a colour texture and the reference's normal-map
    form texture(...) * vector(1, -1, 1); a sphere with texture_scale =
    (0.5, 1.0) and that normal map; a fresnel-coloured sphere; a small OBJ
    with vt whose material mixes by a mono texture; a textured sphere lamp;
    a ray-reading sky (write_texture_images' images). With ``textured``
    False the same geometry with constants in place of every expression
    that reads the ray (UNTEXTURED). ``tiles`` sets the OBJ's grid of
    quads: (3, 2) gives 12 triangles, a dense scene of 15 primitives;
    (16, 16) 512, which the wide BVH takes. ``texture_size`` (a multiple of
    1024) writes write_texture_images' large images, and "_1k" (or "_2k",
    ...) ends the name. ``deep`` wraps the fresnel sphere's colour in
    deep_expression (DEEP; the name "textures_deep"), or with a number in
    that many levels of nesting, every second one a subtraction (the name
    "textures_deep<number>"). A photon-mapping project takes ``photon``'s (photons, photon_bounces, photon_passes,
    radius). Returns the .lua path."""
    os.makedirs(directory, exist_ok=True)
    cols, rows = tiles
    obj = f"tiles_{cols}x{rows}.obj"
    with open(os.path.join(directory, obj), "w") as fh:
        fh.write(_tiles_obj(cols, rows))
    write_texture_images(directory, size=texture_size)
    extra = (f"\n        light_bounces = {light_bounces}," if renderer == "bidirectional" else
             "\n        " + PHOTON_EXTRA % photon if renderer == "photon_mapping" else "")
    nested = deep and deep is not True and deep_expression(TEXTURED["fresnel"], nest=deep,
                                                           subtract=True)
    expressions = DEEP if deep is True else dict(TEXTURED, fresnel=nested) if deep else (
        TEXTURED if textured else UNTEXTURED)
    values = dict(expressions, w=width, h=height, s=spectrum_samples, b=bounces, spp=spp,
                  renderer=renderer, extra=extra, obj=obj)
    name = ("textures" if textured else "untextured") + (
        "_deep" + ("" if deep is True else str(deep)) if deep else "") + (
        {"simple": "", "bidirectional": "_bdpt", "photon_mapping": "_photon"}[renderer]) + (
        "" if tiles == (3, 2) else f"_{2 * cols * rows}") + (
        f"_{texture_size // 1024}k" if texture_size else "")
    path = os.path.join(directory, f"{name}.lua")
    with open(path, "w") as fh:
        fh.write(TEXTURES_SCENE % values)
    return path


SPHERES_SCENE = """
local materials = {
%(materials)s
}
return {
    image = {width = %(w)d, height = %(h)d},
    camera = camera.perspective {
        fov = 50,
        transform = transform.look_at {from = vector(0, 9, -9), to = vector(0, 0, 4)},
    },
    renderer = renderer.simple {
        pixel_samples = 16, spectrum_samples = 4, light_samples = 1, bounces = %(b)d,
    },
    world = {
        sky = 0.2,
        objects = {
%(spheres)s
            shape.sphere {
                radius = 1.5, position = vector(0, 9, 4),
                material = {surface = material.emissive {color = light_source.d65 * 6}},
            },
        },
    },
}
"""


def write_spheres_scene(directory, count=300, width=48, height=32, bounces=3, seed=4,
                        distinct=False, emissive=0, planes=0, spectrum_samples=4,
                        renderer="simple"):
    """A scene of ``count`` small spheres (a jittered grid on the ground,
    from a numpy seed; seven shared materials) and a sphere lamp: above the
    dense kernels' 128 primitives, so it takes the wide BVH. With
    ``distinct`` each sphere has a diffuse colour of its own (from the
    seed: one wavelength-only colour program each, which the scene bakes
    into its bank table), the first ``emissive`` of them mixed half and half
    with an emissive colour of their own (each such sphere a lamp, its
    material two components, one emissive); ``planes`` floors under the
    spheres (the one at y = 0 last, the others below it, out of sight; each
    a grey of its own). ``renderer`` "bidirectional" takes 4 + 4 bounces.
    Returns the .lua path."""
    import numpy as np

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(count)))
    rows = []
    for k in range(count):
        x, z = (k % side) - side / 2, k // side
        p = (x * 0.6 + rng.uniform(-0.1, 0.1), rng.uniform(0.0, 0.3), z * 0.6 + rng.uniform(-0.1, 0.1))
        rows.append(f"            shape.sphere {{radius = 0.25, position = vector({p[0]:.4f}, "
                    f"{p[1]:.4f}, {p[2]:.4f}), material = materials[{(k if distinct else k % 7) + 1}]}},")
    if distinct:
        rgb = lambda c: f"rgb({c[0]:.4f}, {c[1]:.4f}, {c[2]:.4f})"  # noqa: E731
        mats = []
        for k in range(count):
            diffuse = f"material.diffuse {{color = {rgb(rng.uniform(0.05, 0.95, 3))}}}"
            if k < emissive:
                glow = f"material.emissive {{color = {rgb(rng.uniform(0.5, 3.0, 3))}}}"
                diffuse = f"mix({glow}, {diffuse}, 0.5)"
            mats.append(f"    {{surface = {diffuse}}},")
        materials = "\n".join(mats)
    else:
        materials = "\n".join(
            f"    {{surface = material.diffuse {{color = {0.3 + 0.6 * i / 7:.3f}}}}}," for i in range(7))
    for k in range(planes):
        y = -0.01 * (planes - 1 - k)
        rows.append(f"            shape.plane {{origin = vector(0, {y:.2f}, 0), normal = vector(0, 1, 0), "
                    f"material = {{surface = material.diffuse {{color = {0.2 + 0.6 * k / planes:.4f}}}}}}},")
    text = SPHERES_SCENE % {"w": width, "h": height, "b": bounces, "spheres": "\n".join(rows),
                            "materials": materials}
    text = text.replace("spectrum_samples = 4", f"spectrum_samples = {spectrum_samples}")
    name = f"spheres_{count}" if not distinct else f"materials_{count}"
    if renderer != "simple":
        text = text.replace("renderer.simple {", "renderer.bidirectional {\n        light_bounces = 4,")
        text = text.replace("bounces = %d," % bounces, "bounces = 4,")
        name += "_bdpt"
    path = os.path.join(directory, f"{name}.lua")
    with open(path, "w") as fh:
        fh.write(text)
    return path


# Directional lamps (the table form of the reference's directional_light;
# width is the cosine of the cone's half-angle): a sun of a 1.8-degree
# cone, then a width-0 fill, whose cone on a miss is the whole hemisphere
# about its direction, so that a ray into the sun matches both and the
# first, the sun, wins (tracer.bounce_core).
SUN = ('{type = "directional_light", direction = vector(0.3714, 0.7428, 0.5571), '
       'width = 0.9995, color = light_source.d65 * 2},')
FILL = ('{type = "directional_light", direction = vector(-0.3015, 0.9045, 0.3015), '
        'width = 0, color = rgb(0.2, 0.25, 0.4)},')


def add_objects(path, objects, name, replace=()):
    """A copy of the .lua project at ``path`` named ``name``.lua, beside it,
    with ``objects`` (Lua table constructors) first in its world and each
    (old, new) of ``replace`` made in its text. Returns the new path."""
    with open(path) as fh:
        text = fh.read()
    text = text.replace("objects = {", "objects = {\n            " + "\n            ".join(objects), 1)
    for old, new in replace:
        assert old in text, old
        text = text.replace(old, new)
    out = os.path.join(os.path.dirname(path), f"{name}.lua")
    with open(out, "w") as fh:
        fh.write(text)
    return out


def write_sunlit_terrain_scene(directory, cells=405, width=512, height=256, spectrum_samples=10,
                               bounces=4, spp=4, renderer="simple"):
    """terrain_<cells> (tools.synthetic.terrain_scene) under SUN and FILL and
    the sky, at S = ``spectrum_samples``; with ``renderer``
    "bidirectional" 4 + 4 bounces, where the terrain's sphere lamp starts
    every lamp path (a directional lamp starts none). Returns the .lua
    path, sunlit_terrain_<cells>[_bdpt].lua."""
    from tools.synthetic import terrain_scene

    sys.path.insert(0, ROOT)
    base = terrain_scene(directory, cells=cells, width=width, height=height, spp=spp,
                         bounces=bounces)[0]
    replace = [("spectrum_samples = 4,", f"spectrum_samples = {spectrum_samples},")]
    name = f"sunlit_terrain_{cells}"
    if renderer == "bidirectional":
        replace.append(("renderer.simple {", "renderer.bidirectional {\n        light_bounces = 4,"))
        name += "_bdpt"
    return add_objects(base, [SUN, FILL], name, replace)


def write_de_many_scene(directory, count=130, width=128, height=64, spectrum_samples=4, bounces=3):
    """``count`` small cubic quaternion Julias (the julia scene's constant
    at 4 iterations, so that the plain march on the card checks them in
    seconds, each in a bounding sphere of radius 0.3) on a grid over a
    floor, lit by a point lamp: a DE table of more than 128 columns.
    Returns the .lua path, de_<count>.lua."""
    side = next(k for k in range(1, count + 1) if k * k >= count)
    shapes = []
    for k in range(count):
        x, z = (k % side - side / 2) * 0.7, (k // side) * 0.7 + 2
        shapes.append(
            "            shape.ray_marched {shape = ray_marched.quaternion_julia {iterations = 4, "
            "threshold = 4, constant = vector(-0.45, -0.0375, -0.4, -0.025), slice_plane = 0, "
            f"variant = quaternion_julia.cubic}}, bounds = {{type = \"sphere\", position = "
            f"vector({x:.3f}, 0, {z:.3f}), radius = 0.3}}, material = {{surface = "
            f"material.diffuse {{color = rgb(0.8, 0.55, 0.35)}}}}}},")
    text = JULIA_SCENE % {"w": width, "h": height, "s": spectrum_samples, "b": bounces}
    start = text.index("            shape.ray_marched {")
    end = text.index("            shape.plane {")
    text = text[:start] + "\n".join(shapes) + "\n" + text[end:]
    text = text.replace("from = vector(0.4, 0.9, -3.4), to = vector(0, -0.2, 0)",
                        f"from = vector(0, {side * 0.5:.2f}, -2), to = vector(0, 0, {side * 0.35 + 2:.2f})")
    path = os.path.join(directory, f"de_{count}.lua")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def write_de_repeated_scene(directory, count, width=8, height=4, spectrum_samples=4, bounces=2,
                            spp=1):
    """write_de_many_scene's scene of one shape with that shape repeated
    ``count`` times in one place (one Lua object, one material, appended
    ``count`` times by a loop): a scene of ``count`` DE shapes whose closest
    hit is always the first copy, so that its film is the one shape's.
    Returns the .lua path, de_repeated_<count>.lua."""
    with open(write_de_many_scene(directory, 1, width, height, spectrum_samples, bounces)) as fh:
        text = fh.read().replace("pixel_samples = 64", f"pixel_samples = {spp}")
    start = text.index("            shape.ray_marched {")
    end = text.index("            shape.plane {")
    shape = text[start:end].strip().rstrip(",")
    text = (f"local julia = {shape}\nlocal scene = " + text[:start].replace("return {", "{", 1)
            .lstrip() + text[end:].rstrip()
            + f"\nfor i = 1, {count} do scene.world.objects[#scene.world.objects + 1] = julia end"
            + "\nreturn scene\n")
    path = os.path.join(directory, f"de_repeated_{count}.lua")
    with open(path, "w") as fh:
        fh.write(text)
    return path


PLANES_SCENE = """
return {
    image = {width = %(w)d, height = %(h)d},
    renderer = renderer.%(renderer)s {
        pixel_samples = %(spp)d, spectrum_samples = %(s)d, light_samples = 2, bounces = %(b)d,%(extra)s
    },
    camera = camera.perspective {
        fov = 60,
        transform = transform.look_at {from = vector(0, 1.5, -4), to = vector(0, 0.8, 4)},
    },
    world = {
        sky = light_source.d65 * 0.3,
        objects = {
            %(sun)s
            shape.plane {
                origin = vector(0, 0, 0), normal = vector(0, 1, 0),
                material = {surface = material.diffuse {color = rgb(0.7, 0.65, 0.5)}},
            },
            shape.plane {
                origin = vector(0, 0, 6), normal = vector(0.3, 0.2, -1),
                material = {surface = mix(material.mirror {color = 0.9},
                                          material.diffuse {color = rgb(0.2, 0.4, 0.7)}, 0.3)},
            },
            light.point {position = vector(-2, 3, 1), color = light_source.d65 * 40},
        },
    },
}
"""


def write_planes_scene(directory, width=64, height=32, spectrum_samples=4, bounces=3, spp=4,
                       renderer="simple", light_bounces=3):
    """A dense scene of planes alone: no finite primitive and no DE shape
    (the JAX package keeps it out of its dense pack and sweeps it in XLA).
    A ground plane and a tilted plane of a mirror-diffuse mix, a point lamp,
    a directional lamp (SUN) and a D65 sky; ``renderer`` "simple" or
    "bidirectional" (``light_bounces``). Returns the .lua path, planes.lua
    or planes_bdpt.lua."""
    os.makedirs(directory, exist_ok=True)
    extra = f"\n        light_bounces = {light_bounces}," if renderer == "bidirectional" else ""
    name = "planes" + ("_bdpt" if renderer == "bidirectional" else "")
    path = os.path.join(directory, f"{name}.lua")
    with open(path, "w") as fh:
        fh.write(PLANES_SCENE % dict(w=width, h=height, s=spectrum_samples, b=bounces, spp=spp,
                                     renderer=renderer, extra=extra, sun=SUN))
    return path


def texture_paths(directory):
    """The textures scenes of phases 3-6 (write_textures_scene) at the size
    the CLI renders them: textures (256 x 192, S = 6, 4 bounces, 15
    primitives: the dense kProg kernels), untextured (its geometry with
    constants), textures_512 (512 tiles on the wall: the wide kProg
    kernels), textures_1k (a 1024 x 1024 checker and normal map and a 512 x
    512 mask, in a directory of its own), and textures_bdpt and its
    untextured twin untextured_bdpt (bidirectional, 4 + 4 bounces, at
    flagship_bdpt's 512 x 256, S = 6:
    chunks of 131,072 lanes, one a sample). Returns {name: .lua path}."""
    size = dict(width=256, height=192, spectrum_samples=6, bounces=4, spp=16)
    bdpt = dict(width=512, height=256, spectrum_samples=6, bounces=4, spp=2,
                renderer="bidirectional")
    return {
        "textures": write_textures_scene(directory, **size),
        "untextured": write_textures_scene(directory, **size, textured=False),
        "textures_512": write_textures_scene(directory, **size, tiles=(16, 16)),
        "textures_1k": write_textures_scene(os.path.join(directory, "1k"), **size,
                                            texture_size=1024),
        "textures_bdpt": write_textures_scene(directory, **bdpt),
        "untextured_bdpt": write_textures_scene(directory, **bdpt, textured=False),
    }


def terrain_paths(directory, cells=(405, 660), width=256, height=128, spp=8, bounces=4):
    """The mesh scenes: tools/synthetic.terrain_scene at the configuration
    bench.py measured on the TPU (256x128, 8 spp, 4 bounces, S = 4, one
    light sample; 2 * cells^2 diffuse triangles and one emissive D65
    sphere; 405 cells make 328,050 triangles, 660 cells 871,200, whose
    leaves grow past 128 rows to fit the wide tree). Returns
    {"terrain_<cells>": .lua path}."""
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_scene

    return {
        f"terrain_{c}": terrain_scene(directory, cells=c, width=width, height=height, spp=spp,
                                      bounces=bounces)[0]
        for c in cells
    }


def gate_paths(directory):
    """The scenes of the rest of the scene gate on the card (phases 3-6):
    sunlit_terrain_405 (write_sunlit_terrain_scene: terrain_405 at 512 x
    256, S = 10, 4 bounces, under SUN, FILL and the sky) and its
    bidirectional twin (4 + 4 bounces beside the sphere lamp);
    flagship_s32 (the flagship at 512 x 256, 8 bounces, S = 32, under SUN)
    and the plain flagship at S = 17, 24, 33, 64 and 110 (the gate's
    former ceiling; phase 3: one column past a multiple of 16, the widths
    --wide-rows times), flagship_s24_bdpt (bidirectional, 3 light bounces:
    the bounce kernels' kRecord instantiation at S = 24), terrain_24_s32
    (terrain_paths' terrain_24 at S = 32: the wide kernels past 16
    columns) and julia_s24 (write_julia_scene at 64 x 64, S = 24: a DE
    scene past 16 columns); materials_300
    (write_spheres_scene: 300 spheres of a diffuse colour each, 150 of them
    lamps, 130 floors, at 512 x 256, S = 10: the baked colour table) and
    its bidirectional twin; textures_deep (texture_paths' textures with the
    82-instruction, depth-12 colour program of DEEP); de_130
    (write_de_many_scene, 128 x 64, phase 3) and de_520 (64 x 32, phase 3:
    past the 512 shapes the march kernel's shared memory holds without
    opting in). Returns {name: .lua path}."""
    julia_dir = os.path.join(directory, "julia_s24")
    os.makedirs(julia_dir, exist_ok=True)
    flagship = scene_paths(directory, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"]
    spectra = lambda s: [("spectrum_samples = 6", f"spectrum_samples = {s}")]  # noqa: E731
    spheres = dict(count=300, width=512, height=256, distinct=True, emissive=150, planes=130,
                   spectrum_samples=10)
    return {
        "sunlit_terrain_405": write_sunlit_terrain_scene(directory),
        "sunlit_terrain_405_bdpt": write_sunlit_terrain_scene(directory, spp=2,
                                                              renderer="bidirectional"),
        "flagship_s32": add_objects(flagship, [SUN], "flagship_s32", spectra(32)),
        "flagship_s24": add_objects(flagship, [], "flagship_s24", spectra(24)),
        "flagship_s64": add_objects(flagship, [], "flagship_s64", spectra(64)),
        "flagship_s17": add_objects(flagship, [], "flagship_s17", spectra(17)),
        "flagship_s33": add_objects(flagship, [], "flagship_s33", spectra(33)),
        "flagship_s110": add_objects(flagship, [], "flagship_s110", spectra(110)),
        "flagship_s24_bdpt": add_objects(flagship, [], "flagship_s24_bdpt", spectra(24) + [
            ("renderer.simple {", "renderer.bidirectional {\n        light_bounces = 3,"),
            ("pixel_samples = 256", "pixel_samples = 2")]),
        "terrain_24_s32": add_objects(
            terrain_paths(directory, cells=(24,))["terrain_24"], [], "terrain_24_s32",
            [("spectrum_samples = 4,", "spectrum_samples = 32,")]),
        "julia_s24": write_julia_scene(julia_dir, 64, 64, spectrum_samples=24),
        "materials_300": write_spheres_scene(directory, **spheres),
        "materials_300_bdpt": write_spheres_scene(directory, **spheres, renderer="bidirectional"),
        "textures_deep": write_textures_scene(os.path.join(directory, "deep"), 256, 192, 6, 4,
                                              spp=16, deep=True),
        "de_130": write_de_many_scene(directory),
        "de_520": write_de_many_scene(directory, 520, 64, 32),
    }


_SCENES = {}


@contextlib.contextmanager
def bank_table_min(value):
    """Scenes built inside bake a program table from ``value``
    wavelength-only programs on (scene.BANK_TABLE_MIN)."""
    from pyrite_tpu_torch import scene as scene_mod

    saved = scene_mod.BANK_TABLE_MIN
    scene_mod.BANK_TABLE_MIN = value
    try:
        yield
    finally:
        scene_mod.BANK_TABLE_MIN = saved


def without_tables():
    """Scenes built inside keep no baked program table
    (scene.BANK_TABLE_MIN out of reach): their kernels read the per-launch
    [Pc, N, S] bank of exact values, as every scene did before the kernels
    read the table."""
    return bank_table_min(1 << 30)


def bank_key(path):
    """A _gpu_scene key of the scene at ``path`` built without_tables."""
    key = path + "#bank"
    if key not in _SCENES:
        with without_tables():
            _SCENES[key] = load_scene(path)
    return key


def _gpu_scene(path):
    """(scene, film, camera, cfg) of a .lua project, built on the GPU once
    (or of a bank_key)."""
    if path not in _SCENES:
        _SCENES[path] = load_scene(path)
    return _SCENES[path]


def load_scene(path, device="cuda"):
    """(scene, film, camera, cfg) of a .lua project, built on ``device``."""
    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.film import Film
    from pyrite_tpu_torch.scene import CameraModel, build_scene
    from pyrite_tpu_torch.tracer import TraceConfig

    project_data = load_project(path)
    r, im = project_data.project.renderer, project_data.project.image
    return (
        build_scene(project_data, device),
        Film(im.width, im.height, r.spectrum_bins, r.spectrum_span),
        CameraModel.from_ir(project_data.project.camera),
        TraceConfig(r.bounces, r.light_samples, r.spectrum_samples),
    )


def _compare(ref, got, what, flags=True):
    """The port's parity tolerances (tests/test_torch_kernels_dense.py):
    flags exact; vectors and reflectance rtol 1e-3 / atol 1e-4; brightness
    with < 1.5 % divergent lanes and energy within 0.5 %. Returns
    (max abs error of the vectors, max abs brightness error, divergent
    share)."""
    import torch

    if flags:
        for k in ("alive", "aux_alive", "sample_light", "light_events"):
            bad = int((ref[k] != got[k]).sum())
            assert bad == 0, f"{what}: {k} differs on {bad} lanes"
    vec_err = 0.0
    for k in ("origin", "direction", "reflectance"):
        if k in ref:
            diff = (ref[k] - got[k]).abs()
            ok = diff <= 1e-4 + 1e-3 * ref[k].abs()
            assert bool(ok.all()), f"{what}: {k} max error {float(diff.max())}"
            vec_err = max(vec_err, float(diff.max()))
    rb, kb = ref["brightness"], got["brightness"]
    diff = (rb - kb).abs()
    lane_bad = (diff > 1e-4 + 1e-3 * rb.abs()).any(dim=1)
    share = float(lane_bad.float().mean())
    energy_ref, energy = float(rb.sum()), float(kb.sum())
    assert share < 0.015, f"{what}: {share:.4%} divergent lanes"
    assert abs(energy_ref - energy) < 0.005 * max(energy_ref, 1e-6) + 1e-3, (
        f"{what}: energy {energy_ref} vs {energy}"
    )
    assert torch.isfinite(kb).all(), f"{what}: non-finite brightness"
    return vec_err, float(diff.max()), share


def _wavefront(film, camera, cfg, seed, lanes=None, device="cuda"):
    """Primary rays as the main path launches them, from the draws keyed by
    ``seed`` (rng.KeyedDraws): pick_sample_batch samples of the whole film
    in one wavefront, in sample order as renderers.simple.make_render_step
    makes them; or, given ``lanes``, one sample of that many lanes' worth of
    rows. Returns (origin, direction, wavelengths, the wavefront's
    KeyedDraws, which its bounces draw from)."""
    from pyrite_tpu_torch.renderers.simple import chunk_rays, pick_sample_batch
    from pyrite_tpu_torch.rng import KeyedDraws

    if lanes is None:
        draws, rows = KeyedDraws(seed, samples=pick_sample_batch(film)), None
    else:
        draws, rows = KeyedDraws(seed), max(1, min(film.height, lanes // film.width))
    _, origin, direction, wl = chunk_rays(film, camera, cfg, draws, rows=rows, device=device)
    return origin, direction, wl, draws


def check_kernels(name, path, lanes=None, bounces=3, seed=0, cut=None, idle=0.0):
    """Phase 3 for one scene, on the main path's wavefront (``lanes`` cuts
    it to whole rows for a quick check, ``cut`` to its first lanes): from
    the same state and the same generator draws, kernels_dense.bounce_dense
    (both CUDA kernels, NEE accumulating in place) against the plain
    tracer.bounce_core on CUDA tensors, for ``bounces`` bounces, each
    started from the plain state. The NEE kernel is also held alone against
    tracer.trace_direct on its own inputs. ``idle`` starts that share of the
    lanes dead and takes NEE from that share of the NEE lanes, at random.
    Returns the worst errors."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd
    from pyrite_tpu_torch import tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed, lanes)
    origin, direction, wl = origin[:cut], direction[:cut], wl[:cut]
    n = origin.shape[0]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    state["alive"] = ~_idle_lanes(n, idle, seed + 1, "cuda")
    bank = kd.precompute_bank_values(scene, wl)
    has_nee = bool(scene.num_lamps and cfg.light_samples)
    worst = {"bounce": 0.0, "nee": 0.0, "brightness": 0.0, "divergent": 0.0, "nee_divergent": 0.0}
    for b in range(bounces):
        draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, b, "cuda")
        out = kd.bounce_dense(scene, cfg, wl, state, draws, bank)
        plain = tracer.bounce_core(scene, cfg, wl, state, draws)
        torch.cuda.synchronize()
        vec_err, b_err, share = _compare(plain, out, f"{name} bounce {b}")
        worst["bounce"] = max(worst["bounce"], vec_err)
        worst["brightness"] = max(worst["brightness"], b_err)
        worst["divergent"] = max(worst["divergent"], share)
        if has_nee:
            t_de = kd.march_pass(scene, cfg, state) if scene.de_shapes else None
            alone, ctx = kd.launch_bounce_kernel(scene, cfg, wl, state, draws, bank, t_de)
            ctx["nee"] &= ~_idle_lanes(n, idle, seed + 2 + b, "cuda")
            alone["brightness"].zero_()
            t_de_shadow = kd.shadow_pass(scene, cfg, alone, ctx, draws) if scene.de_shapes else None
            kd.launch_nee_kernel(scene, cfg, wl, alone, ctx, draws, bank, t_de_shadow)
            plain_delta = tracer.trace_direct(
                scene, cfg, draws, ctx["nee"], alone["origin"], ctx["flip"], -ctx["flip"],
                wl, ctx["refl_nee"], alone["aux_alive"],
            )
            _, nee_err, nee_share = _compare(
                {"brightness": plain_delta}, {"brightness": alone["brightness"]},
                f"{name} NEE {b}", flags=False,
            )
            worst["nee"] = max(worst["nee"], nee_err)
            worst["nee_divergent"] = max(worst["nee_divergent"], nee_share)
        state = plain
    print(
        f"[kernels] {name}: {n} lanes ({idle:.0%} idle) x {bounces} bounces, S={wl.shape[1]}: "
        f"bounce_dense max abs "
        f"err {worst['bounce']:.3g} (origin/direction/reflectance), brightness "
        f"{worst['brightness']:.3g}, divergent lanes {worst['divergent']:.4%}; NEE alone max abs "
        f"err {worst['nee']:.3g}, divergent {worst['nee_divergent']:.4%} "
        f"(rtol 1e-3, atol 1e-4, < 1.5 % lanes)"
    )
    return worst


def _bits_differ(a, b):
    """Lanes where two tensors differ, floats compared bit for bit."""
    import torch

    if a.is_floating_point():
        return a.view(torch.int32) != b.view(torch.int32)
    return a != b.to(a.dtype)


def _shadow_rays(scene, cfg, origin, direction, hit, keyed, bounce=0, in_place=False):
    """The shadow rays of a wavefront's hits: from each triangle hit (the
    terrain is diffuse, so every such lane takes NEE) toward its sampled
    lamp point, drawn with ``bounce``'s keyed draws, as
    tracer._direct_sample casts them. Returns (origin,
    direction, max_dist, block_below, squared lamp distance) of the
    triangle-hit lanes or, ``in_place``, of every lane, where a lane without
    a triangle hit is idle: it starts at its own origin with max_dist 0 and
    block_below inf, so it stops before the walk, as a lane without NEE
    takes part in the NEE kernel's traversal without a ray."""
    import torch

    from pyrite_tpu_torch import tracer

    cast = hit["kind"] == tracer.KIND_TRIANGLE
    n = origin.shape[0]
    lanes = torch.arange(n, device=origin.device) if in_place else torch.nonzero(cast)[:, 0]
    draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, bounce, origin.device)
    position = (origin + direction * hit["t"][:, None])[lanes]
    if in_place:
        position = torch.where(cast[:, None], position, origin)
    samp = tracer.sample_lamp(scene, draws["lamp_idx"].long()[lanes], position,
                              draws["u_nee"][0][lanes])
    sq = samp["sq_distance"]
    max_dist = torch.sqrt(sq)
    block = torch.sqrt(torch.clamp(sq - tracer.DIST_EPSILON, min=0.0))
    if in_place:
        max_dist, block = _idle_shadow(~cast, max_dist, block)
    return position, samp["direction"], max_dist, block, sq


def _idle_shadow(idle, max_dist, block):
    """Shadow-ray bounds with the ``idle`` lanes stopped before their walk."""
    import torch

    return torch.where(idle, 0.0, max_dist), torch.where(idle, torch.inf, block)


def _idle_lanes(n, share, seed, device):
    """A random ``share`` of ``n`` lanes, as a mask, made with numpy from
    ``seed``."""
    import numpy as np
    import torch

    return torch.as_tensor(np.random.default_rng(seed).random(n) < share, device=device)


def warp_divergence(visits, lanes=None, n=None):
    """(warp divergence factor, (ray, leaf) pairs per distinct leaf within a
    warp) of one traversal's leaf sweeps (an entry of
    tracer.work["leaf_visits"]), its lanes taken 32 to a warp in the
    kernel's order. ``lanes`` maps the traversal's batch to the kernel's
    ``n`` lanes where the batch is a subset of them. The factor is 32 x the
    sum over warps of the most leaves one lane of the warp sweeps, over all
    leaves swept, with lanes that sweep none as idle slots: the row tests a
    warp issued when each thread swept its ray's leaves alone, per row test
    its rays need (1: none wasted; 32: one lane per warp sweeps)."""
    import torch

    lane, slot = visits["lane"], visits["slot"]
    if lanes is not None:
        lane = lanes[lane]
    n = visits["lanes"] if n is None else n
    total = lane.numel()
    if total == 0:
        return 1.0, 1.0
    per_lane = torch.bincount(lane, minlength=-(-n // 32) * 32)
    factor = 32 * int(per_lane.view(-1, 32).max(dim=1).values.sum()) / total
    distinct = torch.unique((lane // 32) * (int(slot.max()) + 1) + slot).numel()
    return factor, total / distinct


def _print_divergence(what, work, lanes=None, n=None):
    """One line per traversal the counted run made (tracer.work's
    "leaf_visits"): leaves per ray, the warp divergence factor and the rays
    per distinct leaf in a warp. ``lanes``, where given, holds for each
    traversal the kernel lane of each of its rays, of ``n``."""
    visits = work.get("leaf_visits", [])
    for j, v in enumerate(visits):
        factor, per_leaf = warp_divergence(v, None if lanes is None else lanes[j], n)
        rays = int(v["lane"].unique().numel())
        label = f" light sample {j}" if len(visits) > 1 else ""
        print(f"[divergence] {what}{label}: {v['lane'].numel()} (ray, leaf) sweeps by {rays} rays "
              f"({v['lane'].numel() / max(rays, 1):.3f} leaves per ray that sweeps); warp "
              f"divergence factor {factor:.3f}; {per_leaf:.3f} rays per distinct leaf in a warp")


def check_queries(name, path, lanes=None, seed=0, cut=None, idle=0.0):
    """Phase 3 for the wide-BVH traversal kernels on one mesh scene, at the
    main path's wavefront (``lanes`` cuts it to whole rows, ``cut`` to its
    first rays): kernels.closest_wide (CUDA) against tracer.intersect_scene
    (plain, on the card) on the camera rays, and kernels.shadow_wide against
    tracer.intersect_shadow on their shadow rays of bounce 0. ``idle`` makes
    that share of the lanes, at random, lanes without a query (the running
    hit at t = 0; a shadow ray stopped before its walk), as dead lanes and
    lanes without NEE take part in the bounce and NEE kernels' traversal.
    t, kind, idx, u and v must be equal on every lane, bit for bit. Returns
    the max abs t error of each query over the finite t, and the counts."""
    import torch

    from pyrite_tpu_torch import kernels, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, _, keyed = _wavefront(film, camera, cfg, seed, lanes)
    origin, direction = origin[:cut], direction[:cut]
    n = origin.shape[0]
    init = tracer.empty_hit(n, "cuda")
    init["t"] = torch.where(_idle_lanes(n, idle, seed + 1, "cuda"), 0.0, init["t"])
    plain = tracer.intersect_scene(scene, origin, direction, init)
    got = kernels.closest_wide(scene, origin, direction, init)
    torch.cuda.synchronize()
    for k in ("t", "kind", "idx", "u", "v"):
        bad = int(_bits_differ(got[k], plain[k]).sum())
        assert bad == 0, f"{name}: closest_wide {k} differs on {bad} of {n} lanes"
    found = plain["kind"] != tracer.KIND_NONE

    so, sd, max_dist, block, sq = _shadow_rays(scene, cfg, origin, direction, plain, keyed)
    m = so.shape[0]
    max_dist, block = _idle_shadow(_idle_lanes(m, idle, seed + 2, "cuda"), max_dist, block)
    t_plain = tracer.intersect_shadow(scene, so, sd, max_dist, block)
    t_got = kernels.shadow_wide(scene, so, sd, max_dist, block)
    torch.cuda.synchronize()
    bad = int(_bits_differ(t_got, t_plain).sum())
    assert bad == 0, f"{name}: shadow_wide t differs on {bad} of {m} shadow rays"
    blocked = torch.isfinite(t_plain) & (t_plain * t_plain < sq - tracer.DIST_EPSILON)
    print(
        f"[kernels] {name}: closest_wide on {n} camera rays ({idle:.0%} idle): hit share "
        f"{float(found.float().mean()):.4f}, t, kind, idx, u and v bit-equal on {n}/{n}; "
        f"shadow_wide on {m} shadow rays of bounce 0 ({idle:.0%} idle): blocked share "
        f"{float(blocked.float().mean()):.4f}, t bit-equal on {m}/{m}; leaf {scene.cluster_leaf}, "
        f"{scene.num_triangles} triangles"
    )
    return {"closest": _max_abs_err(got["t"], plain["t"]), "shadow": _max_abs_err(t_got, t_plain),
            "n": n, "shadow_n": m}


def _max_abs_err(got, plain):
    """max |got - plain| over the lanes where both are finite (0 if none)."""
    import torch

    both = torch.isfinite(got) & torch.isfinite(plain)
    return float((got - plain)[both].abs().max()) if bool(both.any()) else 0.0


def _event_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# FP32 operations per unit of work, counted from the plain version's op
# list, one per arithmetic operation or libm call (a libm call costs more
# instructions than one, so the bounds below are floors): one ray-plane,
# ray-triangle or ray-sphere test; the shading of a lane (pick, programs,
# scatter); one lamp sample; one march step outside the estimator's loop;
# one estimator iteration of each kind; one popped wide-BVH child's slab
# test, a descent's 16 slab tests, one leaf row's test; a kProg hit's frame
# and uv (the cheapest kind, a plane's rotation); one program value at one
# spectral column (a single instruction's four floats: a floor); the photon
# gather's binary-search step, candidate read (its squared distance and
# test), pair (its geometry weight, bin and adds), one factor of a chain
# re-walk and the rest of the re-walk (an exp, the sign), one
# interpolation.
OPS = {
    "plane": 15, "triangle": 53, "sphere": 24, "shade": 150, "lamp": 80, "de_step": 20,
    "mandelbulb": 32, "regular": 55, "cubic": 83, "bicomplex": 63,
    "pop": 21, "descent": 16 * 21, "leaf_row": 53, "frame": 60, "program": 4,
    "search_step": 3, "candidate": 9, "pair": 25, "chain_factor": 6, "chain": 4, "interp": 9,
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _program_bytes(scene):
    """Bytes a kProg launch reads of the programs once: the code, its
    tables and the textures (the leaf values count per lane:
    _surface_leaf_bytes, _nee_leaf_bytes)."""
    pack = scene.dense_pack["tensors"]
    return _nbytes(*(pack[k] for k in ("code_op", "code_val", "code_arg", "code_off", "vecs", "tex",
                                       "tex_info")))


def _per_program(scene, group, ids, values):
    """``values`` [programs] (by KernelPrograms' numbering) at ``group``'s
    programs ``ids`` (a tensor; -1 or out of range: no program, 0)."""
    import torch

    programs = scene.dense_pack["programs"]
    table = torch.tensor(list(values) + [0], device=ids.device)
    count = programs.counts[("prob", "color", "normal", "sky").index(group)]
    ok = (ids >= 0) & (ids < count)
    return table[torch.where(ok, programs.index(group, 0) + ids, len(table) - 1)]


def _leaf_bytes(scene, group, ids, cols=1):
    """Bytes of leaf values that the code of ``group``'s programs ``ids``
    reads at ``cols`` spectral columns: per column 4 a number leaf, 16 a
    4-vector leaf or Burns' basis, each leaf once; 0 for a program that
    runs no code (its values come per launch)."""
    from pyrite_tpu_torch import exprs

    programs = scene.dense_pack["programs"]
    width = {exprs.OP_LEAF: 4, exprs.OP_LEAF4: 16, exprs.OP_TO_NUMBER: 16}
    cell = [sum(w for _, w in {(arg, width[op]) for op, _, arg in programs.program_code(g)
                               if op in width}) for g in range(len(programs.off) - 1)]
    return cols * _per_program(scene, group, ids, cell)


def _taps(scene, group, ids, cols=1, split=True):
    """Texture taps that ``group``'s programs ``ids`` take at ``cols``
    spectral columns: 16 a texture node of the lane code, 16 a node and
    column of the column code (exprs.KernelPrograms.parts); with ``split``
    False (or on a checkout from before the split, whose programs have no
    parts) the kernels' one stream of code at every column."""
    from pyrite_tpu_torch import exprs

    programs = scene.dense_pack["programs"]
    tex = lambda code: 16 * sum(op in (exprs.OP_TEX_COLOR, exprs.OP_TEX_MONO) for op, _, _ in code)
    parts = getattr(programs, "parts", None) if split else None
    g_all = range(len(programs.off) - 1)
    parts = parts or [([], programs.program_code(g)) for g in g_all]
    return (_per_program(scene, group, ids, [tex(parts[g][0]) for g in g_all])
            + cols * _per_program(scene, group, ids, [tex(parts[g][1]) for g in g_all]))


def _surface_cost(scene, cfg, wl, state, u_comp, cost, color=True):
    """Per lane of ``state``, ``cost(group, ids, cols)`` of the programs a
    kProg bounce (``color``) or lamp bounce runs for it: at a hit its
    material's normal program and its picked component's probability
    program (one column each) and, with ``color``, the component's color
    program (S columns); at a miss the sky program (S columns; the lamp
    bounce runs none); 0 for a dead lane."""
    import torch

    from pyrite_tpu_torch import tracer

    a = scene.arrays
    alive, o, d = state["alive"], state["origin"], state["direction"]
    s = wl.shape[1]
    hit = tracer.intersect_scene(scene, o, d, de_steps=cfg.max_de_steps)
    found = alive & (hit["kind"] != tracer.KIND_NONE)
    _, mat, _, _ = tracer._shading_normal(scene, hit, o, d, wl)
    count = torch.clamp(a["mat_comp_count"][mat].long(), min=1)
    comp = a["mat_comp_offset"][mat].long() + torch.minimum((u_comp * count).long(), count - 1)
    per_hit = (cost("normal", a["mat_normal_prog"][mat].long(), 1)
               + cost("prob", a["comp_prob"][comp].long(), 1))
    per_miss = torch.zeros_like(per_hit)
    if color:
        per_hit = per_hit + cost("color", a["comp_color"][comp].long(), s)
        per_miss = per_miss + cost("sky", torch.zeros_like(comp), s)
    return torch.where(found, per_hit, torch.where(alive, per_miss, 0))


def _surface_leaf_bytes(scene, cfg, wl, state, u_comp, color=True):
    """Leaf bytes a kProg bounce (``color``) or lamp bounce reads for the
    alive lanes of ``state`` (_surface_cost)."""
    cost = lambda group, ids, cols: _leaf_bytes(scene, group, ids, cols)
    return int(_surface_cost(scene, cfg, wl, state, u_comp, cost, color).sum())


def _nee_cost(scene, cfg, wl, out, ctx, draws, cost):
    """Per NEE lane, ``cost(group, ids, cols)`` of the programs the kProg
    NEE kernel runs: per shadow ray cast and not blocked, its emitter's
    probability program (one column, a shape lamp's) and color program (S
    columns, one on a lane whose auxiliary columns are dead or dispersed),
    as nee_lane runs them."""
    import torch

    from pyrite_tpu_torch import geometry as geom, tracer

    a = scene.arrays
    s = wl.shape[1]
    nee = torch.nonzero(ctx["nee"])[:, 0]
    p, flip, aux = out["origin"][nee], ctx["flip"][nee], out["aux_alive"][nee]
    total = torch.zeros(nee.numel(), dtype=torch.long, device=p.device)
    for j in range(cfg.light_samples):
        samp = tracer.sample_lamp(scene, draws["lamp_idx"].long()[nee], p, draws["u_nee"][j][nee])
        sq = samp["sq_distance"]
        t = tracer.intersect_shadow(scene, p, samp["direction"], torch.sqrt(sq),
                                    torch.sqrt(torch.clamp(sq - tracer.DIST_EPSILON, min=0.0)),
                                    de_steps=cfg.max_de_steps)
        lit = (geom.dot(flip, samp["direction"]) > 0.0) & ~(t * t < sq - tracer.DIST_EPSILON)
        e_comp, _ = tracer.choose_emissive(scene, samp["surf_mat"], draws["u_emis"][j][nee])
        shape = samp["is_shape"]
        prob = torch.where(shape, a["comp_prob"][e_comp].long(), -1)
        color = torch.where(shape, a["comp_color"][e_comp].long(), samp["color_prog"])
        cols = torch.where(aux & ~(shape & a["comp_prob_uses_wl"][e_comp]), s, 1)
        total += torch.where(lit, cost("prob", prob, 1) + cost("color", color, cols), 0)
    return total


def _nee_leaf_bytes(scene, cfg, wl, out, ctx, draws):
    """Leaf bytes the kProg NEE kernel reads (_nee_cost)."""
    cost = lambda group, ids, cols: _leaf_bytes(scene, group, ids, cols)
    return int(_nee_cost(scene, cfg, wl, out, ctx, draws, cost).sum())


def _print_taps(path, bounce_name, nee_name, scene, cfg, wl, state, draws, out, ctx):
    """Texture taps per lane of the kProg bounce (alive lanes) and NEE
    kernels (NEE lanes; _taps): mean and most, in the kernels' two-part form
    and as one stream at every column."""
    found = {}
    for split in (True, False):
        cost = lambda group, ids, cols: _taps(scene, group, ids, cols, split)
        b = _surface_cost(scene, cfg, wl, state, draws["u_comp"], cost)[state["alive"]]
        n = _nee_cost(scene, cfg, wl, out, ctx, draws, cost)
        found[split] = [(float(x.float().mean()) if x.numel() else 0.0,
                         int(x.max()) if x.numel() else 0) for x in (b, n)]
    print(f"[taps] {os.path.basename(path)}: texture taps per lane (mean, most): {bounce_name} "
          f"{found[True][0]} two-part form, {found[False][0]} one stream at every column; "
          f"{nee_name} {found[True][1]}, one stream {found[False][1]}")


def _work_ops(scene, work, lanes=0, per_lane=0):
    """FP32 operations of ``lanes`` lanes costing ``per_lane`` each plus
    the work the plain version counted (tracer.work)."""
    ops = lanes * per_lane
    if scene.de_shapes:
        est = scene.de_shapes[0].estimator
        per_iter = OPS["mandelbulb" if est["kind"] == "mandelbulb" else est["variant"]]
        ops += work.get("de_steps", 0) * OPS["de_step"] + work.get("de_iterations", 0) * per_iter
    return ops + sum(work.get(k, 0) * OPS[k[:-1]] for k in ("pops", "descents", "leaf_rows"))


def _counted(fn):
    """Run fn once with tracer.work counting; returns the counts."""
    from pyrite_tpu_torch import tracer

    tracer.work = {}
    try:
        fn()
    finally:
        work, tracer.work = tracer.work, None
    return work


def _sweep_ops(scene):
    """FP32 operations of one ray against a dense scene's planes and
    primitives (none on a mesh scene: the counted walk covers those)."""
    ops = scene.num_planes * OPS["plane"]
    if not scene.use_clusters:
        ops += scene.num_triangles * OPS["triangle"] + scene.num_spheres * OPS["sphere"]
    return ops


def _bounce_inputs(path, seed, bounce):
    """The main path's wavefront at ``bounce``: 0, the camera rays, every
    lane alive; 1, the plain bounce_core state after bounce 0, dead lanes in
    place; with that bounce's draws. Returns (scene, cfg, wavelengths,
    state, draws)."""
    from pyrite_tpu_torch import tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed)
    n = origin.shape[0]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    for b in range(bounce):
        draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, b, "cuda")
        state = tracer.bounce_core(scene, cfg, wl, state, draws)
    return scene, cfg, wl, state, tracer.draw_bounce_uniforms(scene, cfg, n, keyed, bounce, "cuda")


def _kernel_rays(scene, cfg, state, draws, out, ctx):
    """The rays the bounce and NEE kernels trace: the lanes of the alive
    lanes' closest-hit queries, and per light sample (lanes, origin,
    direction, lamp distance, occlusion bound) of the shadow rays the NEE
    lanes cast (the lamp sample in front of the surface, as nee_lane casts
    them)."""
    import torch

    from pyrite_tpu_torch import geometry as geom, tracer

    alive = torch.nonzero(state["alive"])[:, 0]
    nee = torch.nonzero(ctx["nee"])[:, 0]
    p, flip = out["origin"][nee], ctx["flip"][nee]
    shadows = []
    for j in range(cfg.light_samples):
        samp = tracer.sample_lamp(scene, draws["lamp_idx"].long()[nee], p, draws["u_nee"][j][nee])
        cast = torch.clamp(geom.dot(flip, samp["direction"]), min=0.0) > 0.0
        sq = samp["sq_distance"][cast]
        shadows.append((nee[cast], p[cast], samp["direction"][cast], torch.sqrt(sq),
                        torch.sqrt(torch.clamp(sq - tracer.DIST_EPSILON, min=0.0))))
    return alive, shadows


def time_kernels(path, card, seed=1, plain_reps=10, bounce=0):
    """Phase 4: per-launch milliseconds on the main path's wavefront at
    ``bounce`` (_bounce_inputs), the scene's bounce and NEE kernels against
    the plain version, each timed in the order plain, kernel, kernel, plain
    after a warm-up; with the bytes each kernel must move and the FP32
    operations its inputs need, counted by the plain version on the rays the
    kernels trace (the alive lanes' bounce, the shadow rays cast). On a
    scene with DE shapes the march passes are timed apart from the bounce
    and NEE kernels, which read their t ("de_march_pass", "de_shadow_pass",
    against tracer.de_hits / kernels_dense.shadow_pass_plain). Returns
    {name: (kernel ms, plain ms, bytes, operations)}."""
    import dataclasses

    from pyrite_tpu_torch import _build, kernels_dense as kd, tracer

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, bounce)
    n = wl.shape[0]
    bank = kd.precompute_bank_values(scene, wl)
    lib = _build.load()
    bounce_name, nee_name = kd.kernel_names(scene)
    bounce_fn = getattr(lib, kd._LAUNCHERS[bounce_name])
    nee_fn = getattr(lib, kd._LAUNCHERS[nee_name])
    de = bool(scene.de_shapes)
    t_de = kd.march_pass(scene, cfg, state) if de else None
    b_args, out, ctx = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank, t_de)
    bounce_fn(*b_args)
    t_de_shadow = kd.shadow_pass(scene, cfg, out, ctx, draws) if de else None
    n_args = kd.nee_kernel_args(scene, cfg, wl, out, ctx, draws, bank, t_de_shadow)
    cfg_no_nee = dataclasses.replace(cfg, light_samples=0)

    runs = {
        bounce_name: lambda: bounce_fn(*b_args),
        nee_name: lambda: nee_fn(*n_args),
        "bounce_dense": lambda: kd.bounce_dense(scene, cfg, wl, state, draws, bank),
    }
    plains = {
        bounce_name: lambda: tracer.bounce_core(scene, cfg_no_nee, wl, state, draws),
        nee_name: lambda: tracer.trace_direct(
            scene, cfg, draws, ctx["nee"], out["origin"], ctx["flip"], -ctx["flip"], wl,
            ctx["refl_nee"], out["aux_alive"],
        ),
        "bounce_dense": lambda: tracer.bounce_core(scene, cfg, wl, state, draws),
    }
    if de:
        # the raw launches write into t_m / t_s, held here while they run
        m_args, t_m = kd.march_pass_args(scene, cfg, state)
        s_args, t_s = kd.shadow_pass_args(scene, cfg, out, ctx, draws)
        runs["de_march_pass"] = lambda: lib.pyrite_de_march_bounce(*m_args)
        runs["de_shadow_pass"] = lambda: lib.pyrite_de_march_shadow(*s_args)
        plains["de_march_pass"] = lambda: tracer.de_hits(
            scene, state["origin"], state["direction"], cfg.max_de_steps, live=state["alive"])
        plains["de_shadow_pass"] = lambda: kd.shadow_pass_plain(scene, cfg, out, ctx, draws)
    alive = int(state["alive"].sum())
    times = _time_pairs(runs, plains, plain_reps, (
        f"per launch at bounce {bounce}, {n} lanes ({alive} alive), S={wl.shape[1]}, "
        f"light_samples={cfg.light_samples} ({card})"
    ))
    # Bytes these inputs need: the scene's tables once; per lane the bounce
    # reads its state, two draws and one spectrum of sky or surface color
    # and writes its state and the NEE context, 24 S + 99 bytes (a dead lane
    # reads and writes its state only: fewer); the NEE kernel reads one flag
    # per lane and, per NEE lane, its context, draws and one lamp color
    # spectrum per light sample, and reads and writes its brightness.
    a = scene.arrays
    tables = _nbytes(scene.dense_pack["tensors"]["sheet"])
    if scene.use_clusters:
        tables += _nbytes(*(a[k] for k in ("wide_rows", "clu_geo", "tri_n", "tri_mat",
                                             "sph_center", "sph_mat")))
    s_count, ls = wl.shape[1], cfg.light_samples
    nee_lanes = int(ctx["nee"].sum())
    n_de = len(scene.de_shapes)
    b_bytes = tables + n * (24 * s_count + 99 + 4 * n_de)
    n_bytes = tables + n + nee_lanes * (29 + 12 * s_count + ls * (20 + 4 * s_count + 4 * n_de))
    if scene.dense_pack["prog"]:
        # the kProg instantiations also read the program tables, the
        # textures and the frame tables once and, per lane, the leaf values
        # of the programs it runs
        b_bytes += _program_bytes(scene) + _nbytes(
            *(a[k] for k in ("tri_q", "tri_uv", "sph_texscale", "pla_quat", "pla_texscale"))
        ) + _surface_leaf_bytes(scene, cfg, wl, state, draws["u_comp"])
        n_bytes += _program_bytes(scene) + _nee_leaf_bytes(scene, cfg, wl, out, ctx, draws)
        _print_taps(path, bounce_name, nee_name, scene, cfg, wl, state, draws, out, ctx)
    lanes, shadows = _kernel_rays(scene, cfg, state, draws, out, ctx)
    b_work = _counted(lambda: tracer.bounce_core(
        scene, cfg_no_nee, wl[lanes], {k: v[lanes] for k, v in state.items()},
        {k: draws[k][lanes] for k in ("u_comp", "u_scatter")}))
    n_work = _counted(lambda: [
        tracer.intersect_shadow(scene, *rays[1:], de_steps=cfg.max_de_steps) for rays in shadows])
    # the marches, now the passes' work: out of the kernels' counts
    m_work = _counted(lambda: tracer.de_hits(
        scene, state["origin"][lanes], state["direction"][lanes], cfg.max_de_steps))
    s_work = _counted(lambda: [tracer.de_hits(scene, *rays[1:3], cfg.max_de_steps, t_cap=rays[3])
                               for rays in shadows])
    b_work, n_work = _less(b_work, m_work), _less(n_work, s_work)
    cast = sum(rays[0].numel() for rays in shadows)
    frame = OPS["frame"] if scene.dense_pack["prog"] else 0
    b_ops = _work_ops(scene, b_work, alive, _sweep_ops(scene) + OPS["shade"] + frame)
    n_ops = _work_ops(scene, n_work, nee_lanes * ls, OPS["lamp"]) + cast * _sweep_ops(scene)
    print(f"[work] {os.path.basename(path)} at bounce {bounce}: {bounce_name} {alive} alive lanes, "
          f"{b_bytes} bytes, {b_ops} FP32 operations ({_plain_counts(b_work)}); {nee_name} "
          f"{nee_lanes} NEE lanes x {ls} light samples, {cast} shadow rays cast, {n_bytes} bytes, "
          f"{n_ops} operations ({_plain_counts(n_work)})")
    result = {
        bounce_name: (*times[bounce_name], b_bytes, b_ops),
        nee_name: (*times[nee_name], n_bytes, n_ops),
    }
    if de:
        # the march pass reads each lane's ray and flag and writes n_de t;
        # the shadow pass reads a flag per lane and, per NEE lane, its
        # position, facing normal, lamp index and draws, and writes n_de t
        # per light sample and lane; operations: the counted marches and,
        # per shadow ray, its lamp sample
        sheet = _nbytes(scene.dense_pack["tensors"]["sheet"])
        m_bytes = sheet + n * (25 + 4 * n_de)
        s_bytes = sheet + n * (1 + 4 * n_de * ls) + nee_lanes * (28 + 16 * ls)
        result["de_march_pass"] = (*times["de_march_pass"], m_bytes, _work_ops(scene, m_work))
        result["de_shadow_pass"] = (*times["de_shadow_pass"], s_bytes,
                                    _work_ops(scene, s_work, nee_lanes * ls, OPS["lamp"]))
        print(f"[work] {os.path.basename(path)} march passes at bounce {bounce}: bounce rays "
              f"{_plain_counts(m_work)}, shadow rays {_plain_counts(s_work)}")
    base = os.path.basename(path)
    _print_divergence(f"{base} {bounce_name} at bounce {bounce}", b_work, [lanes], n)
    _print_divergence(f"{base} {nee_name} at bounce {bounce}", n_work,
                      [rays[0] for rays in shadows], n)
    _print_bounds(f"{base} at bounce {bounce}", result)
    return result


def _plain_counts(work):
    """tracer.work's counts, without the per-lane records."""
    return {k: v for k, v in work.items() if not isinstance(v, list)}


def _less(work, part):
    """tracer.work's counts less those of ``part``, a share of its work."""
    return dict(work, **{k: work.get(k, 0) - v for k, v in _plain_counts(part).items()})


def _print_bounds(what, result):
    """Each kernel's time beside its bound, as the kernels line gives them."""
    for name, (ms, plain_ms, size, ops) in result.items():
        by_bytes, by_ops = size / HBM_BYTES_PER_S * 1e3, ops / _fp32_rate() * 1e3
        print(f"[bound] {what} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(by_bytes, by_ops):.4f} ms ({'bytes' if by_bytes >= by_ops else 'operations'})")


def _time_pairs(runs, plains, plain_reps, what):
    """Mean ms of each run and of its plain version, in the order plain,
    run, run, plain after a warm-up (two calls of the run, one of the plain
    version, which takes seconds a call on the DE scenes); {key: (run,
    plain)}."""
    import torch

    times = {}
    for key in runs:
        for _ in range(2):
            runs[key]()
        plains[key]()
        torch.cuda.synchronize()
        p1 = _event_ms(plains[key], plain_reps)
        k1 = _event_ms(runs[key], 50)
        k2 = _event_ms(runs[key], 50)
        p2 = _event_ms(plains[key], plain_reps)
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[times] {key}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms {what}")
    return times


def _query_inputs(path, seed):
    """The ray queries of the main path's wavefront on a mesh scene, by
    bounce: {0: camera rays and their shadow rays (the triangle-hit lanes
    alone), 1: the rays of the plain bounce_core state after bounce 0 with
    dead lanes in place (the running hit at t = 0 there) and their shadow
    rays in place}, each ((origin, direction, init), (origin, direction,
    max_dist, block_below))."""
    import torch

    from pyrite_tpu_torch import tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed)
    n = origin.shape[0]
    hit = tracer.intersect_scene(scene, origin, direction)
    shadow = _shadow_rays(scene, cfg, origin, direction, hit, keyed)[:4]
    queries = {0: ((origin, direction, tracer.empty_hit(n, "cuda")), shadow)}
    draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cuda")
    state = tracer.bounce_core(scene, cfg, wl, tracer.initial_state(origin, direction, wl.shape[1]),
                               draws)
    init = tracer.empty_hit(n, "cuda")
    init["t"] = torch.where(state["alive"], init["t"], 0.0)
    o, d = state["origin"], state["direction"]
    hit = tracer.intersect_scene(scene, o, d, init)
    queries[1] = ((o, d, init), _shadow_rays(scene, cfg, o, d, hit, keyed, 1, in_place=True)[:4])
    return scene, queries


def time_queries(path, card, seed=1, plain_reps=3):
    """Phase 4 for the traversal kernels: closest_wide and shadow_wide on
    _query_inputs at bounces 0 and 1, against tracer.intersect_scene /
    intersect_shadow. Returns {name: (kernel ms, plain ms, bytes,
    operations)}, bounce 0 under the kernel's name, bounce 1 under
    "<name> at bounce 1"."""
    from pyrite_tpu_torch import kernels, tracer

    scene, queries = _query_inputs(path, seed)
    a = scene.arrays
    tables = [scene.dense_pack["tensors"]["sheet"], a["wide_rows"], a["clu_geo"]]
    base = os.path.basename(path)
    out = {}
    for bounce, (closest, shadow) in queries.items():
        suffix = "" if bounce == 0 else f" at bounce {bounce}"
        runs = {
            "wide_closest_kernel" + suffix: lambda c=closest: kernels.closest_wide(scene, *c),
            "wide_shadow_kernel" + suffix: lambda s=shadow: kernels.shadow_wide(scene, *s),
        }
        plains = {
            "wide_closest_kernel" + suffix: lambda c=closest: tracer.intersect_scene(scene, *c),
            "wide_shadow_kernel" + suffix: lambda s=shadow: tracer.intersect_shadow(scene, *s),
        }
        n, m = closest[0].shape[0], shadow[0].shape[0]
        times = _time_pairs(runs, plains, plain_reps, (
            f"per query at bounce {bounce}, {n} rays / {m} shadow rays ({card})"
        ))
        sizes = {  # rays and the running hit in and out; rays, bounds and t
            "wide_closest_kernel": _nbytes(*tables, *closest[:2]) + 2 * n * 20,
            "wide_shadow_kernel": _nbytes(*tables, *shadow) + 4 * m,
        }
        rays = {  # the rays that walk: not idle
            "wide_closest_kernel": int((closest[2]["t"] > 0).sum()),
            "wide_shadow_kernel": int((shadow[2] > 0).sum()),
        }
        for name in sizes:
            work = _counted(plains[name + suffix])
            ops = _work_ops(scene, work, rays[name], _sweep_ops(scene))
            print(f"[work] {base} {name} at bounce {bounce}: {rays[name]} rays that walk, "
                  f"{_plain_counts(work)}, {sizes[name]} bytes, {ops} FP32 operations")
            _print_divergence(f"{base} {name} at bounce {bounce}", work)
            out[name + suffix] = (*times[name + suffix], sizes[name], ops)
    _print_bounds(base, out)
    return out


def _de_march_args(scene, cfg, origin, direction, shape):
    """The march toward one DE shape as tracer.intersect_de sets it up:
    (estimator, local origin, direction, t0, tmax, hit, max steps, omega)."""
    import math

    import torch

    from pyrite_tpu_torch import tracer

    hit, tmin, tmax, center = tracer._de_bounds(shape, origin, direction)
    t0 = torch.where(hit, tmin, math.inf)
    return (shape.estimator, origin - center, direction, t0, tmax, hit, cfg.max_de_steps,
            tracer.DE_OMEGA)


def _differ(a, b):
    """Lanes where two float tensors differ bit for bit, a NaN on both sides
    counting as equal."""
    import torch

    return _bits_differ(a, b) & ~(torch.isnan(a) & torch.isnan(b))


def march_divergence(orbits, lanes=None, n=None):
    """(iterations, issue slots, longest ray's iterations) of one march's
    counted orbits (an entry of tracer.work["de_orbits"]), its rays taken 32
    to a warp in lane order (``lanes`` maps the march's batch to the
    kernel's ``n`` lanes where the batch is a subset of them). The slots are
    32 x the sum over warps and march steps of the longest orbit among the
    warp's rays at that step: what a warp issues when each thread marches
    its own ray, every iteration in the thread, as the bounce and NEE kernels
    did before the march pass. iterations / slots is that design's SIMT
    efficiency."""
    import torch

    lane, step, its = orbits["lane"], orbits["step"], orbits["iterations"].long()
    if lanes is not None:
        lane = lanes[lane]
    n = orbits["lanes"] if n is None else n
    total = int(its.sum())
    if total == 0:
        return 0, 0, 0
    steps = int(step.max()) + 1
    longest = torch.zeros(-(-n // 32) * steps, dtype=torch.long, device=its.device)
    longest.scatter_reduce_(0, (lane // 32) * steps + step, its, "amax")
    per_ray = torch.zeros(n, dtype=torch.long, device=its.device).index_add_(0, lane, its)
    return total, 32 * int(longest.sum()), int(per_ray.max())


def _print_march_divergence(what, rays, counts):
    """The [divergence] march line of ``counts``, march_divergence's tuples
    summed (the longest ray: the most of any)."""
    total, slots = sum(c[0] for c in counts), sum(c[1] for c in counts)
    longest = max((c[2] for c in counts), default=0)
    print(f"[divergence] march {what}: {rays} rays, {total} estimator iterations; SIMT "
          f"efficiency of the in-thread march {total / max(slots, 1):.3f}; longest ray "
          f"{longest} iterations")
    return total, longest


def check_march(name, path, lanes=None, seed=0, cut=None, idle=0.0):
    """Phase 3 for march_de_kernel on one DE scene's camera wavefront
    (``lanes`` cuts it to whole rows, ``cut`` to its first rays; ``idle``
    takes that share of the rays, at random, out of the march: hit false for
    the query, dead lanes for the pass): kernels.march_de (the query)
    against tracer.march_de_plain for each DE shape, and the bounce march
    pass kernels_dense.march_pass against tracer.de_hits, on the card. Hit
    flags, total, dist and t must be equal on every ray, bit for bit. Prints
    the camera rays' [divergence] march line. Returns {"err": max abs t
    error, "n": rays, "iterations": estimator iterations of the camera rays,
    "longest": the longest ray's}."""
    import torch

    from pyrite_tpu_torch import kernels, kernels_dense as kd, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, _, _ = _wavefront(film, camera, cfg, seed, lanes)
    origin, direction = origin[:cut], direction[:cut]
    n = origin.shape[0]
    live = ~_idle_lanes(n, idle, seed + 1, "cuda")
    worst = {"err": 0.0, "n": n}
    counts = []
    for j, shape in enumerate(scene.de_shapes):
        args = list(_de_march_args(scene, cfg, origin, direction, shape))
        args[5] = args[5] & live
        tmax, hit = args[4], args[5]
        total_k, dist_k = kernels.march_de(*args)
        plain = []
        work = _counted(lambda: plain.append(tracer.march_de_plain(*args)))
        (total_p, dist_p), = plain
        torch.cuda.synchronize()
        counts.append(march_divergence(work["de_orbits"][0]))
        ok_k, ok_p = hit & (total_k <= tmax), hit & (total_p <= tmax)
        flags = int((ok_k != ok_p).sum())
        totals, dists = int(_differ(total_k, total_p).sum()), int(_differ(dist_k, dist_p).sum())
        assert flags == 0 and totals == 0 and dists == 0, (
            f"{name}: march_de_kernel differs from the plain march on {n} rays: hit flags "
            f"{flags}, total {totals}, dist {dists}")
        print(f"[kernels] {name}: march_de_kernel on {n} camera rays ({idle:.0%} without a ray), "
              f"DE shape {j} ({shape.estimator['kind']}, {shape.bounds_kind} bounds): "
              f"{int(hit.sum())} enter the bounds, {int(ok_p.sum())} hit; hit flags, total and "
              f"dist bit-equal on {n}/{n}")
    state = {"origin": origin, "direction": direction, "alive": live}
    t_k = kd.march_pass(scene, cfg, state)
    t_p = tracer.de_hits(scene, origin, direction, cfg.max_de_steps, live=live)
    torch.cuda.synchronize()
    bad = int(_bits_differ(t_k, t_p).sum())
    assert bad == 0, f"{name}: the march pass's t differs on {bad} of {t_k.numel()} (shape, ray)"
    worst["err"] = _max_abs_err(t_k, t_p)
    print(f"[kernels] {name}: march pass (march_de_kernel over the bounce rays) on {n} rays x "
          f"{len(scene.de_shapes)} DE shape(s), {int(live.sum())} alive: t bit-equal on "
          f"{t_k.numel()}/{t_k.numel()}, {int(torch.isfinite(t_p).sum())} hits")
    worst["iterations"], worst["longest"] = _print_march_divergence(
        f"{name} camera rays", int(live.sum()), counts)
    return worst


def check_shadow_pass(name, path, lanes=None, seed=0, cut=None, idle=0.0):
    """Phase 3 for the shadow march pass on one DE scene's bounce-0 NEE
    rays (``lanes``, ``cut`` as check_march; ``idle`` starts that share of
    the lanes dead and takes NEE from that share of the NEE lanes): the
    bounce kernel after the march pass, then kernels_dense.shadow_pass on the
    card against tracer.intersect_de capped at the lamp distance
    (tracer.de_hits) on each light sample's shadow rays
    (kernels_dense.shadow_rays, the rays nee_lane casts): t bit-equal on
    every (shape, light sample, lane), inf where no ray is cast. Prints the
    shadow rays' [divergence] march line. Returns the max abs t error."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed, lanes)
    origin, direction, wl = origin[:cut], direction[:cut], wl[:cut]
    n = origin.shape[0]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    state["alive"] = ~_idle_lanes(n, idle, seed + 1, "cuda")
    draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cuda")
    bank = kd.precompute_bank_values(scene, wl)
    out, ctx = kd.launch_bounce_kernel(scene, cfg, wl, state, draws, bank,
                                       kd.march_pass(scene, cfg, state))
    ctx["nee"] &= ~_idle_lanes(n, idle, seed + 2, "cuda")
    got = kd.shadow_pass(scene, cfg, out, ctx, draws)
    err, cast_rays, counts = 0.0, 0, []
    for j in range(cfg.light_samples):
        d, dist, cast = kd.shadow_rays(scene, out, ctx, draws, j)
        sel = torch.nonzero(cast)[:, 0]
        plain = []
        work = _counted(lambda: plain.append(tracer.de_hits(
            scene, out["origin"][sel], d[sel], cfg.max_de_steps, t_cap=dist[sel])))
        torch.cuda.synchronize()
        bad = int(_bits_differ(got[:, j, sel], plain[0]).sum())
        assert bad == 0, f"{name}: the shadow pass's t differs on {bad} rays of light sample {j}"
        assert bool(torch.isinf(got[:, j][:, ~cast]).all()), f"{name}: t on a ray not cast"
        err = max(err, _max_abs_err(got[:, j, sel], plain[0]))
        cast_rays += sel.numel()
        counts += [march_divergence(o, sel, n) for o in work["de_orbits"]]
    print(f"[kernels] {name}: shadow pass (march_de_kernel over the NEE shadow rays) on {n} lanes "
          f"({int(ctx['nee'].sum())} take NEE) x {cfg.light_samples} light samples x "
          f"{len(scene.de_shapes)} DE shape(s): {cast_rays} rays cast, t bit-equal on "
          f"{got.numel()}/{got.numel()}")
    _print_march_divergence(f"{name} shadow rays of bounce 0", cast_rays, counts)
    return err


def de_shadow_share(name, path, seed=0):
    """The share of bounce-0 NEE lanes on DE hits whose shadow ray is
    blocked, by the plain version on the card: the JAX package's shadow rule
    takes DE hits at any t, so the DE surface shadows itself (ROADMAP.md
    queue 3)."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed)
    n = origin.shape[0]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, 0, "cuda")
    _, ctx = kd.launch_bounce_kernel(scene, cfg, wl, state, draws,
                                     kd.precompute_bank_values(scene, wl),
                                     kd.march_pass(scene, cfg, state))
    hit = tracer.intersect_scene(scene, origin, direction, de_steps=cfg.max_de_steps)
    lanes = torch.nonzero(ctx["nee"] & (hit["kind"] == tracer.KIND_DE))[:, 0]
    position = (origin + direction * hit["t"][:, None])[lanes]
    samp = tracer.sample_lamp(scene, draws["lamp_idx"].long()[lanes], position, draws["u_nee"][0][lanes])
    sq = samp["sq_distance"]
    t = tracer.intersect_shadow(scene, position, samp["direction"], torch.sqrt(sq),
                                de_steps=cfg.max_de_steps)
    blocked = torch.isfinite(t) & (t * t < sq - tracer.DIST_EPSILON)
    share = float(blocked.float().mean()) if lanes.numel() else 0.0
    print(f"[de-shadow] {name}: {lanes.numel()} of {n} lanes take NEE on a DE hit at bounce 0; "
          f"{share:.4f} of their first shadow rays are blocked")
    return share


def time_march(path, card, seed=1, plain_reps=2):
    """Phase 4 for the DE march kernel: march_de_kernel and its plain
    version on the camera wavefront of a DE scene, with the march steps and
    estimator iterations the plain version counts; the same rays ordered
    longest first and the longest ray alone (the floor no scheduling
    removes); and the issue-based bound (sass_per_iteration). Returns
    {"march_de_kernel": (kernel ms, plain ms, bytes, operations)}."""
    import torch

    from pyrite_tpu_torch import kernels, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, _, _ = _wavefront(film, camera, cfg, seed)
    args = _de_march_args(scene, cfg, origin, direction, scene.de_shapes[0])
    n = origin.shape[0]
    times = _time_pairs(
        {"march_de_kernel": lambda: kernels.march_de(*args)},
        {"march_de_kernel": lambda: tracer.march_de_plain(*args)},
        plain_reps, f"per march, {n} camera rays ({card})",
    )
    work = _counted(lambda: tracer.march_de_plain(*args))
    size = _nbytes(*args[1:6]) + 2 * 4 * n  # 9 inputs in, total and dist out
    ops = _work_ops(scene, work)
    iterations, slots, longest = march_divergence(work["de_orbits"][0])
    print(f"[work] {os.path.basename(path)} march_de_kernel: {n} rays, {work['de_steps']} march "
          f"steps, {iterations} estimator iterations, {size} bytes, {ops} FP32 operations; "
          f"longest ray {longest} iterations; SIMT efficiency of the in-thread march "
          f"{iterations / max(slots, 1):.3f}")
    # the same rays longest first (by the plain march's iterations per ray),
    # and the longest ray alone: what ordering could gain, and the floor
    orbits = work["de_orbits"][0]
    per_ray = torch.zeros(n, dtype=torch.long, device=orbits["lane"].device).index_add_(
        0, orbits["lane"], orbits["iterations"].long())
    order = torch.argsort(per_ray, descending=True)
    pick = lambda lanes: [a[lanes] if isinstance(a, torch.Tensor) else a for a in args]
    ordered, alone = pick(order), pick(order[:1])
    first_ms = _event_ms(lambda: kernels.march_de(*ordered), 20)
    alone_ms = _event_ms(lambda: kernels.march_de(*alone), 20)
    print(f"[march order] {os.path.basename(path)} march_de_kernel: as launched "
          f"{times['march_de_kernel'][0]:.4f} ms; the same rays longest first {first_ms:.4f} ms; "
          f"the longest ray alone ({longest} iterations) {alone_ms:.4f} ms, "
          f"{alone_ms * 1e3 / max(longest, 1):.4f} us per iteration ({card})")
    est = scene.de_shapes[0].estimator
    kind = "mandelbulb" if est["kind"] == "mandelbulb" else "julia"
    per_iteration = sass_per_iteration()
    issue_ms = iterations * per_iteration[kind] / _issue_rate() * 1e3
    print(f"[bound] {os.path.basename(path)} march_de_kernel, issue-based: {iterations} iterations "
          f"x {per_iteration[kind]} SASS instructions per {kind} iteration (fast path, libm calls "
          f"inlined; {per_iteration}) / (132 SMs x 4 schedulers x 32 lanes x clock) = "
          f"{issue_ms:.4f} ms; kernel {times['march_de_kernel'][0]:.4f} ms ({card})")
    return {"march_de_kernel": (*times["march_de_kernel"], size, ops)}


def _lane_keys(film, planes, bounces, seed):
    """Random indexed-mode keys on the card: (rng.LaneKeys of random
    pixels, samples and depths of ``planes`` x the film's lanes, a random
    camera mask), numpy-seeded."""
    import numpy as np
    import torch

    from pyrite_tpu_torch import rng

    r = np.random.default_rng(seed)
    n = planes * film.width * film.height
    word = lambda hi: torch.from_numpy(r.integers(0, hi, n).astype(np.int32)).cuda()
    keys = rng.LaneKeys(seed, word(film.width * film.height), word(2**31 - 1), word(bounces))
    return keys, torch.from_numpy(r.random(n) < 0.3).cuda()


def check_draws(name, path, seed=5):
    """Phase 3 for philox_draws_kernel in both modes, each launched twice,
    against rng.py's plain version on the card and on the CPU, bit for bit
    (a seed's draws do not depend on the device). Affine, on the one-shot
    wavefront: a render step's camera draws and bounces 0 and 1's
    (rng.KeyedDraws(seed, sample0=batch, samples=batch)). Indexed, at the
    regeneration scheduler's width with random pixels, samples and depths
    (rng.LaneKeys): lane_draws (camera draws on a random mask and bounce
    draws at each lane's depth, the regeneration iteration's one launch),
    bounce draws at one bounce for all lanes (the survivor pool's), and the
    affine wavefront's indices, which must give the affine draws. Returns
    the max abs difference measured (0.0 when they are bit-equal)."""
    import torch

    from pyrite_tpu_torch import rng
    from pyrite_tpu_torch.renderers.simple import _regen_planes, pick_sample_batch

    scene, film, camera, cfg = _gpu_scene(path)
    batch = pick_sample_batch(film)
    n = batch * film.width * film.height
    keyed = rng.KeyedDraws(seed, sample0=batch, samples=batch)
    ls, lamps, s = cfg.light_samples, scene.num_lamps, cfg.spectrum_samples
    lanes, mask = _lane_keys(film, _regen_planes(film), cfg.bounces, seed)
    m = lanes.pixel.shape[0]
    lane = torch.arange(n, dtype=torch.int32, device="cuda")
    n_pix = film.width * film.height
    as_lanes = rng.LaneKeys(seed, lane % n_pix, batch + lane // n_pix)
    cpu = torch.device("cpu")
    pool_keys = rng.LaneKeys(seed, lanes.pixel, lanes.sample)
    at = lambda keys, dev: rng.LaneKeys(keys.seed, *(None if t is None else t.to(dev)
                                                     for t in (keys.pixel, keys.sample, keys.depth)))
    joined = lambda c, b: dict(b, camera=c)

    def flat(out):
        return out if isinstance(out, dict) else {"camera": out}

    cases = {  # what: (kernel, plain on a device)
        "affine camera": (lambda: rng.camera_uniforms(keyed, n, s, "cuda"),
                          lambda dev: rng.camera_plain(keyed, n, s, dev)),
        "indexed camera (affine indices)": (lambda: rng.camera_uniforms(as_lanes, n, s, "cuda"),
                                            lambda dev: rng.camera_plain(keyed, n, s, dev)),
        "indexed lane_draws": (
            lambda: joined(*rng.lane_draws(lanes, s, ls, lamps, mask, "cuda")),
            lambda dev: joined(*rng.lane_draws_plain(at(lanes, dev), s, ls, lamps, mask.to(dev), dev))),
        "indexed bounce 2 (pool)": (
            lambda: rng.bounce_draws(pool_keys, m, 2, ls, lamps, "cuda"),
            lambda dev: rng.bounce_plain(at(pool_keys, dev), m, 2, ls, lamps, dev)),
    }
    for b in (0, 1):
        cases[f"affine bounce {b}"] = (lambda b=b: rng.bounce_draws(keyed, n, b, ls, lamps, "cuda"),
                                       lambda dev, b=b: rng.bounce_plain(keyed, n, b, ls, lamps, dev))
        cases[f"indexed bounce {b} (affine indices)"] = (
            lambda b=b: rng.bounce_draws(as_lanes, n, b, ls, lamps, "cuda"),
            lambda dev, b=b: rng.bounce_plain(keyed, n, b, ls, lamps, dev))
    words, err = 0, 0.0
    for what, (kernel, plain) in cases.items():
        got, again = flat(kernel()), flat(kernel())
        on_card, ref = flat(plain(torch.device("cuda"))), flat(plain(cpu))
        torch.cuda.synchronize()
        for k, want in ref.items():
            for other, by in ((got[k], "the kernel"), (again[k], "the kernel again"),
                              (on_card[k], "the plain version on the card")):
                bad = int(_bits_differ(other.cpu(), want).sum())
                assert bad == 0, f"{name}: {what}, {k}: {by} differs from the CPU on {bad} words"
                err = max(err, float((other.cpu().double() - want.double()).abs().max()))
            words += want.numel()
    print(f"[kernels] {name}: philox_draws_kernel, affine on {n} lanes ({batch} samples from sample "
          f"{batch}) and indexed on {m} lanes (random pixels, samples, depths, camera mask): "
          f"{', '.join(cases)}, each launched twice: bit-equal to rng.py's plain version on the "
          f"card and on the CPU, {words} words")
    return err


def time_draws(path, card, seed=5, plain_reps=5):
    """Phase 4 for philox_draws_kernel: per launch, the raw launcher against
    rng.py's plain version on the card, in both modes: affine, one bounce's
    draws of the one-shot wavefront; indexed, a regeneration iteration's
    lane_draws (camera draws on a mask of ~30 % of the lanes, bounce draws
    at each lane's depth) at the regeneration width, the main path's. bound
    = the bytes it moves / 3.35 TB/s: the words it writes (the camera rows
    of every lane, zeros off the mask) and, indexed, the three int32 keys
    and the mask byte it reads per lane. Also times torch.rand of as many
    uniforms (PyTorch's own Philox, other bits; the port never calls it).
    Returns {"philox_draws_kernel": (indexed kernel ms, plain ms, bytes,
    0)}."""
    import torch

    from pyrite_tpu_torch import _build, rng
    from pyrite_tpu_torch.renderers.simple import _regen_planes, pick_sample_batch

    scene, film, camera, cfg = _gpu_scene(path)
    batch = pick_sample_batch(film)
    n = batch * film.width * film.height
    keyed = rng.KeyedDraws(seed, sample0=batch, samples=batch)
    ls, lamps, s = cfg.light_samples, scene.num_lamps, cfg.spectrum_samples
    words, _ = rng._layout(n, ls, lamps)
    buf = torch.empty(words, dtype=torch.float32, device="cuda")
    k0, k1 = keyed.key()
    stream = torch.cuda.current_stream().cuda_stream
    affine = (k0, k1, n, keyed.n_pix(n), keyed.pixel0, keyed.sample0, 1, 0, ls, lamps, 0,
              buf.data_ptr(), 0, 0, 0, 0, 0, 0, 0, 0, stream)
    keys, mask = _lane_keys(film, _regen_planes(film), cfg.bounces, seed)
    m = keys.pixel.shape[0]
    m_words, _ = rng._layout(m, ls, lamps)
    cam = torch.empty((m, s + 5), dtype=torch.float32, device="cuda")
    out = torch.empty(m_words, dtype=torch.float32, device="cuda")
    indexed = (k0, k1, m, 1, 0, 0, 0, s, ls, lamps, cam.data_ptr(), out.data_ptr(),
               keys.pixel.data_ptr(), keys.sample.data_ptr(), keys.depth.data_ptr(),
               mask.view(torch.uint8).data_ptr(), 0, 0, 0, 0, stream)
    lib = _build.load()
    cuda = torch.device("cuda")
    times = _time_pairs(
        {"affine": lambda: lib.pyrite_philox_draws(*affine),
         "indexed": lambda: lib.pyrite_philox_draws(*indexed)},
        {"affine": lambda: rng.bounce_plain(keyed, n, 1, ls, lamps, cuda),
         "indexed": lambda: rng.lane_draws_plain(keys, s, ls, lamps, mask, cuda)},
        plain_reps, f"philox_draws_kernel: affine, one bounce's draws of {n} lanes, {words} words; "
        f"indexed, lane_draws of {m} lanes, {m * (s + 5) + m_words} words written ({card})")
    rand_ms = _event_ms(lambda: torch.rand(words, device="cuda"), 50)
    print(f"[times] torch.rand of {words} f32 uniforms (PyTorch's Philox, other bits; the port "
          f"never calls it): {rand_ms:.4f} ms ({card})")
    _print_bounds(f"{os.path.basename(path)} affine", {"philox_draws_kernel": (
        *times["affine"], 4 * words, 0)})
    result = {"philox_draws_kernel": (*times["indexed"], 4 * (m * (s + 5) + m_words) + 13 * m, 0)}
    _print_bounds(f"{os.path.basename(path)} indexed", result)
    return result


def _warps(x, n, fill=0):
    """A per-lane tensor [n, ...] padded to whole warps, as [warps, 32, ...]."""
    import torch

    warps = -(-n // 32)
    out = torch.full((warps * 32, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    out[:n] = x
    return out.view(warps, 32, *x.shape[1:])


BRANCHES = ("emissive", "diffuse", "mirror", "refractive", "miss")


def bounce_warp_counts(path, card, bounce, seed=1):
    """Phase 4, what rows 1-2 do per warp, counted from the plain version on
    the card at ``bounce`` (_bounce_inputs), lanes 32 to a warp in launch
    order: the branch each alive lane takes (BRANCHES, the component pick of
    tracer.bounce_core) and how many distinct branches a warp's alive lanes
    take; on a scene with DE shapes, the lanes whose ray hits a DE shape
    (k per warp) and the estimator iterations of their six
    central-difference probes (tracer.de_normal's, by tracer._de_orbits),
    with the issue slots a warp spends on them when each hit lane runs its
    own six probes (in the lane's thread: per probe, the warp's longest
    orbit), when the warp's 32 threads take the 6k probes round-robin (per
    round of 32, the longest; csrc/bounce.cu de_normals_shared) and, as a
    floor, when they would be refilled per iteration (no fewer than the
    warp's iterations over 32 and its longest probe), and the issue-based
    bound of the probes
    (iterations x SASS per iteration / issue rate). Returns {"iterations",
    "in_thread", "round_robin", "refill", "issue_ms"} (zeros without DE
    shapes)."""
    import torch

    from pyrite_tpu_torch import tracer

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, bounce)
    o, d, alive = state["origin"], state["direction"], state["alive"]
    n = o.shape[0]
    a = scene.arrays
    hit = tracer.intersect_scene(scene, o, d, de_steps=cfg.max_de_steps)
    found = hit["kind"] != tracer.KIND_NONE
    _, _, mat = tracer.surface_data(scene, hit, o, d)
    count = torch.clamp(a["mat_comp_count"][mat].long(), min=1)
    pick = torch.minimum((draws["u_comp"] * count).long(), count - 1)
    bsdf = a["comp_bsdf"][a["mat_comp_offset"][mat].long() + pick].long()
    branch = torch.where(alive, torch.where(found, bsdf, 4), len(BRANCHES))
    taken = torch.zeros(n, len(BRANCHES) + 1, device=o.device).scatter_(1, branch[:, None], 1.0)
    per_warp = _warps(taken, n)[:, :, : len(BRANCHES)].amax(dim=1)
    distinct = per_warp.sum(dim=1).long()
    spread = torch.bincount(distinct, minlength=len(BRANCHES) + 1).tolist()
    lanes = taken[:, : len(BRANCHES)].sum(dim=0).long().tolist()
    base = os.path.basename(path)
    print(f"[warps] {base} at bounce {bounce}: {n} lanes, {int(alive.sum())} alive; alive lanes by "
          f"branch {dict(zip(BRANCHES, lanes))}; warps by distinct branches taken "
          f"{dict(enumerate(spread))} ({card})")
    result = {"iterations": 0, "in_thread": 0, "round_robin": 0, "refill": 0, "issue_ms": 0.0}
    if not scene.de_shapes:
        return result
    de = alive & (hit["kind"] == tracer.KIND_DE)
    k = _warps(de, n, False).sum(dim=1)
    its = torch.zeros((n, 6), dtype=torch.long, device=o.device)
    offsets = torch.cat([torch.eye(3) * tracer.DIST_EPSILON, -torch.eye(3) * tracer.DIST_EPSILON])
    for j, shape in enumerate(scene.de_shapes):
        sel = torch.nonzero(de & (hit["idx"] == j))[:, 0]
        if sel.numel() == 0:
            continue
        center = torch.as_tensor(shape.center, device=o.device)
        local = (o[sel] - center) + d[sel] * (hit["t"][sel] - tracer.DIST_EPSILON)[:, None]
        probes = (local[None, :, :] + offsets.to(o.device)[:, None, :]).reshape(-1, 3)
        got = []
        _counted(lambda: got.append(tracer._de_orbits(shape.estimator, probes)[1]))
        its[sel] = got[0].long().view(6, -1).t()
    total = int(its.sum())
    in_thread = 32 * int(_warps(its, n).amax(dim=1).sum())
    # round-robin: a warp's tasks in (hit lane rank, axis) order, 32 a round
    lane = torch.nonzero(de)[:, 0]
    rank = torch.cumsum(_warps(de, n, False).long(), dim=1).view(-1)[lane] - 1
    task = rank[:, None] * 6 + torch.arange(6, device=o.device)[None, :]
    slot = (lane // 32)[:, None] * 6 + task // 32
    longest = torch.zeros(-(-n // 32) * 6, dtype=torch.long, device=o.device)
    longest.scatter_reduce_(0, slot.reshape(-1), its[lane].reshape(-1), "amax")
    round_robin = 32 * int(longest.sum())
    # refilled per iteration: no fewer trips than the warp's iterations over
    # 32 threads, nor than its longest probe
    per_warp = _warps(its, n).sum(dim=(1, 2))
    longest_warp = _warps(its, n).amax(dim=(1, 2))
    refill = 32 * int(torch.maximum(-(-per_warp // 32), longest_warp).sum())
    est = scene.de_shapes[0].estimator
    kind = "mandelbulb" if est["kind"] == "mandelbulb" else "julia"
    issue_ms = total * sass_per_iteration()[kind] / _issue_rate() * 1e3
    hist = torch.bincount(k, minlength=33)
    bins = {"0": int(hist[0]), "1-4": int(hist[1:5].sum()), "5-16": int(hist[5:17].sum()),
            "17-31": int(hist[17:32].sum()), "32": int(hist[32])}
    with_hits = k[k > 0].float()
    print(f"[warps] {base} at bounce {bounce}: DE-hit lanes {int(de.sum())}; warps by DE-hit "
          f"lanes k {bins}, mean k {float(with_hits.mean()) if with_hits.numel() else 0.0:.2f} over "
          f"the warps with one; the six probes' estimator iterations {total} "
          f"({total / max(6 * int(de.sum()), 1):.2f} per probe); SIMT efficiency of the probes "
          f"in-thread {total / max(in_thread, 1):.3f} ({in_thread} issue slots), round-robin "
          f"{total / max(round_robin, 1):.3f} ({round_robin}), refilled per iteration at most "
          f"{total / max(refill, 1):.3f} ({refill}); issue-based bound of the probes "
          f"{issue_ms:.4f} ms ({total} x {sass_per_iteration()[kind]} SASS per {kind} iteration) "
          f"({card})")
    return {"iterations": total, "in_thread": in_thread, "round_robin": round_robin,
            "refill": refill, "issue_ms": issue_ms}


# Copy-only probes of the bounce kernel's memory traffic: per lane they read
# its state (origin, direction, brightness, reflectance, one [N, S] row of
# sky or program values, flags, light events, u_comp, u_scatter) and write
# its outputs (origin, direction, facing normal, brightness, reflectance,
# pre-BRDF reflectance, flags, light events), 24 S + 91 bytes, with no
# shading: copy_lanes with one thread per lane touching its own rows, as
# the bounce kernel did before it staged its state (the memory floor as that
# access reaches it), copy_staged through shared memory a block at a time.
COPY_PROBE_SRC = r"""
#include "common.cuh"

struct CopyArgs {
  const float *o, *d, *b, *r, *c;
  const uint8_t *alive, *aux, *sl;
  const int* le;
  const float *u_comp, *u_sc;
  float *oo, *od, *of, *ob, *orf, *orn;
  uint8_t *o_alive, *o_aux, *o_sl, *o_nee;
  int* o_le;
  int n, s;
};

__global__ void __launch_bounds__(BLOCK) copy_lanes(const CopyArgs a) {
  const int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane >= a.n) return;
  const size_t row = (size_t)lane * a.s;
  const V3 o = load3(a.o, lane), d = load3(a.d, lane);
  const float u = a.u_comp[lane] + a.u_sc[3 * lane] + a.u_sc[3 * lane + 1] + a.u_sc[3 * lane + 2];
  for (int k = 0; k < a.s; ++k) {
    const float b = a.b[row + k], r = a.r[row + k], c = a.c[row + k];
    a.ob[row + k] = b + c * r;
    a.orf[row + k] = r * c;
    a.orn[row + k] = r * u;
  }
  store3(a.oo, lane, o + d);
  store3(a.od, lane, d);
  store3(a.of, lane, o);
  a.o_alive[lane] = a.alive[lane];
  a.o_aux[lane] = a.aux[lane];
  a.o_sl[lane] = a.sl[lane];
  a.o_nee[lane] = a.alive[lane];
  a.o_le[lane] = a.le[lane] + 1;
}

__global__ void __launch_bounds__(BLOCK) copy_staged(const CopyArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int base = blockIdx.x * BLOCK, lane = base + threadIdx.x, rows = min(BLOCK, a.n - base);
  const int s = a.s, t = threadIdx.x;
  float *B = sm, *R = B + BLOCK * s, *C = R + BLOCK * s, *O = C + BLOCK * s, *D = O + 3 * BLOCK,
        *U = D + 3 * BLOCK;
  const size_t sp = (size_t)base * s, vp = (size_t)base * 3;
  block_copy(B, a.b + sp, rows * s);
  block_copy(R, a.r + sp, rows * s);
  block_copy(C, a.c + sp, rows * s);
  block_copy(O, a.o + vp, rows * 3);
  block_copy(D, a.d + vp, rows * 3);
  block_copy(U, a.u_sc + vp, rows * 3);
  __syncthreads();
  if (lane < a.n) {
    const float u = a.u_comp[lane] + U[3 * t] + U[3 * t + 1] + U[3 * t + 2];
    for (int k = 0; k < s; ++k) {
      const float b = B[t * s + k], r = R[t * s + k], c = C[t * s + k];
      B[t * s + k] = b + c * r;
      R[t * s + k] = r * c;
      C[t * s + k] = r * u;
    }
    const V3 o = {O[3 * t], O[3 * t + 1], O[3 * t + 2]}, d = {D[3 * t], D[3 * t + 1], D[3 * t + 2]};
    U[3 * t] = o.x; U[3 * t + 1] = o.y; U[3 * t + 2] = o.z;
    O[3 * t] = o.x + d.x; O[3 * t + 1] = o.y + d.y; O[3 * t + 2] = o.z + d.z;
    a.o_alive[lane] = a.alive[lane];
    a.o_aux[lane] = a.aux[lane];
    a.o_sl[lane] = a.sl[lane];
    a.o_nee[lane] = a.alive[lane];
    a.o_le[lane] = a.le[lane] + 1;
  }
  __syncthreads();
  block_copy(a.ob + sp, B, rows * s);
  block_copy(a.orf + sp, R, rows * s);
  block_copy(a.orn + sp, C, rows * s);
  block_copy(a.oo + vp, O, rows * 3);
  block_copy(a.od + vp, D, rows * 3);
  block_copy(a.of + vp, U, rows * 3);
}

extern "C" int copy_probe(int staged, const CopyArgs* a, void* stream) {
  const int grid = (a->n + BLOCK - 1) / BLOCK;
  if (staged)
    copy_staged<<<grid, BLOCK, (3 * a->s + 9) * BLOCK * sizeof(float), (cudaStream_t)stream>>>(*a);
  else
    copy_lanes<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
"""


def time_copy_probes(path, card, seed=1, bounce=0):
    """Phase 4: the copy-only probes (COPY_PROBE_SRC, built with the
    library's flags) on the bounce kernel's tensors at ``bounce`` of the
    main path's wavefront: ms per launch of each, with the bytes they move
    and the rate. Returns {"copy_lanes": ms, "copy_staged": ms, "bytes": b}."""
    import ctypes

    import torch

    from pyrite_tpu_torch import _build

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, bounce)
    n, s = wl.shape
    f32 = torch.float32
    empty = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype, device="cuda")
    sky = empty(n, s).uniform_()
    u8 = lambda t: t.view(torch.uint8)
    ins = [state["origin"], state["direction"], state["brightness"], state["reflectance"], sky,
           u8(state["alive"]), u8(state["aux_alive"]), u8(state["sample_light"]),
           state["light_events"], draws["u_comp"], draws["u_scatter"]]
    outs = [empty(n, 3), empty(n, 3), empty(n, 3), empty(n, s), empty(n, s), empty(n, s)] + [
        empty(n, dtype=torch.uint8) for _ in range(4)] + [empty(n, dtype=torch.int32)]

    class CopyArgs(ctypes.Structure):
        _fields_ = [(f"p{i}", ctypes.c_void_p) for i in range(len(ins) + len(outs))] + [
            ("n", ctypes.c_int), ("s", ctypes.c_int)]

    cargs = CopyArgs(*[t.data_ptr() for t in ins + outs], n, s)
    with tempfile.TemporaryDirectory() as tmp:
        src, so = os.path.join(tmp, "copy_probe.cu"), os.path.join(tmp, "copy_probe.so")
        with open(src, "w") as fh:
            fh.write(COPY_PROBE_SRC)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o",
                        so, src], check=True, capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(so)
    lib.copy_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    size = _nbytes(*ins, *outs)
    out = {"bytes": size}
    for staged, name in ((0, "copy_lanes"), (1, "copy_staged")):
        run = lambda: lib.copy_probe(staged, ctypes.byref(cargs), stream)
        assert run() == 0, f"{name} launch failed"
        torch.cuda.synchronize()
        out[name] = (_event_ms(run, 50) + _event_ms(run, 50)) / 2
    print(f"[copy probe] {os.path.basename(path)} at bounce {bounce}: {n} lanes, S={s}, {size} bytes "
          f"(bytes bound {size / HBM_BYTES_PER_S * 1e3:.4f} ms): copy_lanes (per-lane rows) "
          f"{out['copy_lanes']:.4f} ms, {size / out['copy_lanes'] / 1e6:.1f} GB/s; copy_staged "
          f"(block staged, float4) {out['copy_staged']:.4f} ms, "
          f"{size / out['copy_staged'] / 1e6:.1f} GB/s ({card})")
    return out


def print_occupancy(s, stack=8):
    """Resident blocks of 128 threads per SM of the bounce and NEE kernels'
    instantiations at S spectral columns, the kProg ones at a program
    stack of ``stack`` values (pyrite_bounce_occupancy; the kProg ones
    "n/a" in a checkout whose query does not give them)."""
    import ctypes

    from pyrite_tpu_torch import _build

    blocks = (ctypes.c_int * 12)(*([-1] * 12))
    query = _build.load().pyrite_bounce_occupancy
    # a checkout from before the kProg stack's depth was an argument
    rc = query(s, blocks) if len(query.argtypes) == 2 else query(s, stack, blocks)
    assert rc == 0, f"pyrite_bounce_occupancy: cudaError {rc}"
    names = [f"{k}<{v}>" for k in ("dense_bounce_kernel", "dense_nee_kernel", "wide_bounce_kernel",
                                    "wide_nee_kernel") for v in ("false", "true")] + [
        f"{k}<false><prog>" for k in ("dense_bounce_kernel", "dense_nee_kernel",
                                      "wide_bounce_kernel", "wide_nee_kernel")]
    found = dict(zip(names, list(blocks)))
    print(f"[occupancy] S={s}: resident blocks of 128 threads per SM (warps per SM, of 64): " +
          "; ".join(f"{k} {b} ({4 * b})" if b >= 0 else f"{k} n/a" for k, b in found.items()))
    return found


# One estimator iteration of each kind between the same loads and stores
# (csrc/march_de.cuh), and the loads and stores alone, for
# sass_per_iteration: built with the library's flags, read with cuobjdump.
PROBE_SRC = r'''
#include "march_de.cuh"

__device__ __forceinline__ Orbit probe_in(const float* in, V3& p) {
  const int i = threadIdx.x;
  p = {in[i], in[i + 32], in[i + 64]};
  return {{in[i + 96], in[i + 128], in[i + 160], in[i + 192]},
          {in[i + 224], in[i + 256], in[i + 288], in[i + 320]}, in[i + 352], (int)in[i + 384]};
}

__device__ __forceinline__ void probe_out(const Orbit& o, bool done, float* out) {
  const int i = threadIdx.x;
  out[i] = o.z.s; out[i + 32] = o.z.x; out[i + 64] = o.z.y; out[i + 96] = o.z.z;
  out[i + 128] = o.dz.s; out[i + 160] = o.dz.x; out[i + 192] = o.dz.y; out[i + 224] = o.dz.z;
  out[i + 256] = o.r; out[i + 288] = (float)o.it + (done ? 0.5f : 0.0f);
}

extern "C" __global__ void probe_base(const DeShape s, const float* in, float* out) {
  V3 p;
  Orbit o = probe_in(in, p);
  probe_out(o, p.x > s.threshold, out);
}

extern "C" __global__ void probe_mandelbulb(const DeShape s, const float* in, float* out) {
  V3 p;
  Orbit o = probe_in(in, p);
  const bool done = mandelbulb_step(s, p, o);
  probe_out(o, done, out);
}

extern "C" __global__ void probe_julia(const DeShape s, const float* in, float* out) {
  V3 p;
  Orbit o = probe_in(in, p);
  const bool done = julia_step(s, o);
  probe_out(o, done, out);
}
'''


def _sass_counts(sass):
    """{function: instructions before its first EXIT} of cuobjdump -sass
    output: the path that runs when no branch leaves it, which is where the
    compiler lays out the common path; the libm calls' slow paths follow the
    EXIT."""
    counts, name, done = {}, None, False
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\w+)", line)
        if head:
            name, done = head.group(1), False
            counts[name] = 0
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name is None or done or not op:
            continue
        if op.group(1).startswith("EXIT"):
            done = True
        elif op.group(1) != "NOP":
            counts[name] += 1
    return counts


_SASS = {}  # sass_per_iteration's result, once per process


def sass_per_iteration():
    """SASS instructions of one estimator iteration of each kind
    ({"mandelbulb": m, "julia": j, the cubic Julia}): the probe kernels of
    PROBE_SRC built with _build.NVCC_FLAGS against csrc/march_de.cuh, less
    the loads and stores around them, from cuobjdump -sass."""
    from pyrite_tpu_torch import _build

    if _SASS:
        return _SASS

    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
        with open(src, "w") as fh:
            fh.write(PROBE_SRC)
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-cubin", "-o", cubin, src],
                       check=True, capture_output=True, text=True, timeout=300)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True, text=True, timeout=120).stdout
    counts = _sass_counts(sass)
    _SASS.update({k: counts[f"probe_{k}"] - counts["probe_base"] for k in ("mandelbulb", "julia")})
    return _SASS


def _issue_rate():
    """Lane-instructions the card issues per second: 132 SMs x 4 warp
    schedulers x 32 lanes x the max SM clock."""
    return 132 * 4 * 32 * _SM_CLOCK_MHZ[-1] * 1e6


def _zero_counts():
    from pyrite_tpu_torch import kernels, kernels_dense as kd, rng, tracer
    from pyrite_tpu_torch.renderers import bidirectional as bd, photon as ph, simple

    for counts in (kd.launches, kernels.launches, tracer.launches, rng.launches, simple.counters,
                   bd.counters, ph.counters, tracer.lane_bounces):
        for k in counts:
            counts[k] = 0


def _read_counts():
    from pyrite_tpu_torch import cli

    return _flat_counts(cli._count_tables())


def _flat_counts(tables):
    """One dict of the count tables ``tables`` (cli._count_tables' names:
    this process's, or a rank's from cli.render_rank)."""
    photon = {k: int(v) for k, v in tables["photon"].items()}
    photon["photon_camera_bounces"] = photon.pop("camera_bounces")
    lanes = tables["lane_bounces"]
    return dict(tables["kernels_dense"], **tables["kernels"], **tables["tracer"], **tables["rng"],
                **tables["simple"], **{k: int(v) for k, v in tables["bidirectional"].items()},
                **photon, live_lane_bounces=lanes["live"], executed_lane_bounces=lanes["executed"],
                lamp_live=lanes["lamp_live"], lamp_executed=lanes["lamp_executed"])


class scheduler:
    """Within the block, renderers.simple.render takes ``which``:
    "regen" (its default), "pool" (regeneration off: the survivor pool at
    POOL_MIN_BOUNCES bounces or more; ``stage`` and ``cont`` set
    STAGE_BOUNCES and CONT_BOUNCES, so that shallow scenes take it too, with
    every bounce count) or "one-shot" (regeneration and the pool off)."""

    def __init__(self, which, stage=None, cont=None):
        self.which, self.stage, self.cont = which, stage, cont

    def __enter__(self):
        from pyrite_tpu_torch.renderers import simple

        self.saved = {k: getattr(simple, k) for k in (
            "regen_enabled", "POOL_MIN_BOUNCES", "STAGE_BOUNCES", "CONT_BOUNCES")}
        simple.regen_enabled = lambda: self.which == "regen"
        if self.which == "one-shot":
            simple.POOL_MIN_BOUNCES = 10**6
        if self.which == "pool" and self.stage is not None:
            simple.POOL_MIN_BOUNCES, simple.STAGE_BOUNCES, simple.CONT_BOUNCES = 1, self.stage, self.cont
        return self

    def __exit__(self, *exc):
        from pyrite_tpu_torch.renderers import simple

        for k, v in self.saved.items():
            setattr(simple, k, v)


def _lanes_line(launches):
    live, executed = launches["live_lane_bounces"], launches["executed_lane_bounces"]
    return (f"lane-bounces live {live}, executed {executed} (live share "
            f"{live / max(executed, 1):.4f})")


def render_end_to_end(path, samples, card, out_dir, passes=False, which="regen", bank=False):
    """Phase 5: the CLI on the GPU through the scheduler ``which`` (regen,
    the default, pool or one-shot: see ``scheduler``); checks the PNG, the
    film and that every bounce iteration went through the scene's CUDA
    kernels (kernels_dense.kernel_names: one bounce and one NEE launch each)
    and, with ``passes`` (a scene with DE shapes), one march pass and one
    shadow march pass each; that the draw kernel ran once per regeneration
    iteration (pool: once per stage for the camera and once per bounce).
    Prints the live and executed lane-bounces, the peak memory and the
    bytes a lane of the wavefront took (the peak over the memory held
    before the render, per lane, beside renderers.simple.lane_bytes). With
    ``bank`` the scene is built without_tables. Returns the launch counts
    of the run."""
    import numpy as np
    import torch
    from PIL import Image

    from pyrite_tpu_torch import cli, kernels_dense as kd
    from pyrite_tpu_torch.renderers import simple

    result = {}
    render = simple.render

    def recording_render(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        started = time.perf_counter()
        film, acc, wt = render(*args, **kwargs)
        torch.cuda.synchronize()
        result.update(film=film, acc=acc, wt=wt, seconds=time.perf_counter() - started,
                      peak=torch.cuda.max_memory_allocated(), base=base)
        return film, acc, wt

    out_png = os.path.join(out_dir, os.path.basename(path) + f".{which}.png")
    simple.render = recording_render
    _zero_counts()
    try:
        with scheduler(which), without_tables() if bank else contextlib.nullcontext():
            rc = cli.main([path, "--samples", str(samples), "--device", "cuda", "--output", out_png])
    finally:
        simple.render = render
    launches = _read_counts()
    assert rc == 0, f"cli.main returned {rc}"
    film, acc, wt = result["film"], result["acc"], result["wt"]
    assert bool(torch.isfinite(acc).all() and torch.isfinite(wt).all()), "film is not finite"
    with Image.open(out_png) as img:
        pixels = np.asarray(img)
    assert pixels.shape == (film.height, film.width, 3), pixels.shape
    assert pixels.max() > 0, "the image is all black"
    scene = _gpu_scene(bank_key(path) if bank else path)[0]
    kernels = kd.kernel_names(scene)
    bounces = launches["bounces"]
    assert bounces > 0 and launches[kernels[0]] == bounces, launches
    assert launches[kernels[1]] == bounces, launches
    assert launches["bounce_core"] == 0, launches
    marches = bounces if passes else 0
    assert launches["de_march_pass"] == launches["de_shadow_pass"] == marches, launches
    r = cli.load_project(path).project.renderer
    pix = film.width * film.height
    lane_bytes = simple.lane_bytes(scene, r.spectrum_samples, r.light_samples)
    if which == "regen":
        assert launches["regen_iterations"] == bounces > 0, launches
        assert launches["philox_draws_kernel"] == bounces, launches
        lanes = simple._regen_planes(film, scene.texture_bytes, lane_bytes) * pix
    elif which == "pool":
        assert launches["pool_stages"] == samples and launches["pool_flushes"] > 0, launches
        assert launches["philox_draws_kernel"] == samples + bounces, launches
        lanes = simple.POOL_FACTOR * pix
    else:
        assert launches["regen_iterations"] == launches["pool_stages"] == 0, launches
        lanes = min(simple.pick_sample_batch(film, scene.texture_bytes, lane_bytes), samples) * pix
    rays = pix * samples * r.bounces * (1 + r.light_samples)
    print(
        f"[end-to-end] {os.path.basename(path)}{' (bank)' if bank else ''} {film.width}x"
        f"{film.height}, {samples} spp, "
        f"S={r.spectrum_samples}, {r.bounces} bounces, {which}: "
        f"{rays / result['seconds'] / 1e6:.3f} Mrays/s nominal, render wall "
        f"{result['seconds']:.3f} s, peak memory {result['peak'] / 2**20:.1f} MiB (textures "
        f"{scene.texture_bytes / 2**20:.3f} MiB of it) ({card}); "
        f"{_lanes_line(launches)}; launches {launches}; image mean {pixels.mean():.2f}/255"
    )
    print(f"[memory] {os.path.basename(path)}{' (bank)' if bank else ''} {which}: peak "
          f"{result['peak']} B ({result['peak'] / 2**20:.1f} MiB) over {result['base']} B held "
          f"before the render, {lanes} lanes: {(result['peak'] - result['base']) / lanes:.1f} B a "
          f"lane (simple.lane_bytes {lane_bytes})")
    return launches


def compare_schedulers(name, path, samples, card):
    """Phase 5: the same render through the one-shot wavefront,
    regeneration and the survivor pool (with a 2-bounce stage and 3-bounce
    continuations, so that it pools and flushes at any bounce count) on the
    card: the keyed draws make the three trace the same paths, so wt must be
    equal and acc within rtol 1e-4 (summation order; the pool's exposure
    adds in atomic order). Prints the largest differences and returns the
    largest relative one."""
    import torch

    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import simple

    scene = _gpu_scene(path)[0]
    project_data = load_project(path)
    films = {}
    for which, stage in (("one-shot", None), ("regen", None), ("pool", 2)):
        _zero_counts()
        with scheduler(which, stage, 3):
            _, acc, wt = simple.render(project_data, scene, seed=4, max_samples=samples)
        launches = _read_counts()
        assert launches["bounce_core"] == 0, launches
        films[which] = (acc, wt)
        print(f"[schedulers] {name} {which}: {_lanes_line(launches)}, bounce iterations "
              f"{launches['bounces']}")
    acc0, wt0 = films["one-shot"]
    worst = 0.0
    for which in ("regen", "pool"):
        acc, wt = films[which]
        bad = int((wt != wt0).sum())
        diff = (acc - acc0).abs()
        rel = float((diff / acc0.abs().clamp_min(1e-30)).max())
        print(f"[schedulers] {name}, {samples} spp: {which} against one-shot: wt differs in {bad} "
              f"bins of {wt.numel()} (total {float(wt.sum()):.1f}); acc max abs diff "
              f"{float(diff.max()):.3e}, max rel {rel:.3e} ({card})")
        assert bad == 0, f"{name}: {which}'s wt differs from the one-shot film's"
        torch.testing.assert_close(acc, acc0, rtol=1e-4, atol=0.0)
        worst = max(worst, rel)
    return worst


def drive_queries(path, card, seed=2):
    """Phase 5, the mesh ray-query path: one render step's camera rays of a
    mesh scene through kernels.closest_wide and their shadow rays of bounce
    0 through kernels.shadow_wide, on the card. Checks the hits are finite
    and real and returns the launch counts of the run."""
    import torch

    from pyrite_tpu_torch import kernels, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, _, keyed = _wavefront(film, camera, cfg, seed)
    _zero_counts()
    torch.cuda.synchronize()
    started = time.perf_counter()
    hit = kernels.closest_wide(scene, origin, direction)
    so, sd, max_dist, block, sq = _shadow_rays(scene, cfg, origin, direction, hit, keyed)
    t = kernels.shadow_wide(scene, so, sd, max_dist, block)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    launches = _read_counts()
    found = hit["kind"] != tracer.KIND_NONE
    assert bool(found.any()) and bool(torch.isfinite(hit["t"][found]).all()), "no camera ray hit"
    assert bool(((hit["t"] > 0) | ~found).all()), "a hit at t <= 0"
    blocked = torch.isfinite(t) & (t * t < sq - tracer.DIST_EPSILON)
    assert launches["wide_closest_kernel"] == 1 and launches["wide_shadow_kernel"] == 1, launches
    print(
        f"[queries] {os.path.basename(path)}: {origin.shape[0]} camera rays (hit share "
        f"{float(found.float().mean()):.4f}) and {so.shape[0]} shadow rays (blocked share "
        f"{float(blocked.float().mean()):.4f}) in {seconds * 1e3:.3f} ms wall ({card}); "
        f"launches {launches}"
    )
    return launches


def drive_march(path, card, seed=2):
    """Phase 5, the DE march path: one render step's camera rays of a DE
    scene through tracer.intersect_de with the march in its CUDA kernel
    (kernels.march_de), on the card. Checks the hits lie inside the bounds
    and returns the launch counts of the run."""
    import torch

    from pyrite_tpu_torch import kernels, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, _, _ = _wavefront(film, camera, cfg, seed)
    _zero_counts()
    torch.cuda.synchronize()
    started = time.perf_counter()
    results = [
        tracer.intersect_de(shape, origin, direction, cfg.max_de_steps, march=kernels.march_de)
        for shape in scene.de_shapes
    ]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - started
    launches = _read_counts()
    assert launches["march_de_kernel"] == len(scene.de_shapes), launches
    for ok, t in results:
        assert bool(ok.any()) and bool(torch.isfinite(t[ok]).all()), "no ray hit the DE shape"
        assert bool((t[ok] >= 0).all()), "a DE hit at t < 0 on a camera ray"
    print(
        f"[march] {os.path.basename(path)}: {origin.shape[0]} camera rays, hit share "
        f"{float(results[0][0].float().mean()):.4f}, in {seconds * 1e3:.3f} ms wall ({card}); "
        f"launches {launches}"
    )
    return launches


# --- the bidirectional renderer (phases 3-5) -------------------------------------


def _bdpt_text(text, bounces, light_bounces):
    """A simple project's text as renderer.bidirectional at ``bounces`` +
    ``light_bounces``."""
    return text.replace("renderer.simple", "renderer.bidirectional").replace(
        f"bounces = {bounces},", f"bounces = {bounces}, light_bounces = {light_bounces},", 1)


def write_flagship_bdpt(directory, name, bounces, light_bounces, width=512, height=256):
    """__graft_entry__._SCENE_SRC with renderer.bidirectional at S = 6 and
    ``bounces`` + ``light_bounces``, as ``directory/name.lua``."""
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _SCENE_SRC

    path = os.path.join(directory, name + ".lua")
    with open(path, "w") as fh:
        fh.write(_bdpt_text(_SCENE_SRC % {"w": width, "h": height, "s": 6, "b": bounces}, bounces,
                            light_bounces))
    return path


def bdpt_scene_paths(directory, spp=4, small=False):
    """The bidirectional renderer's scenes on the card: cornell_class
    (write_cornell_scene at the reference workload's settings),
    flagship_bdpt (__graft_entry__._SCENE_SRC with renderer.bidirectional,
    as __graft_entry__._build writes it, at 512 x 256, S = 6, 8 + 8
    bounces),
    flagship_bdpt_24 (the same at light_bounces = 24: the two-phase step),
    flagship_bdpt_deep (the same at 16 + 8 bounces: the regen scheduler),
    flagship_bdpt_64 and flagship_bdpt_256 (at 64 and 256 camera bounces,
    the reference snowflake's budget: --profile's regen crossover),
    terrain_405_bdpt (tools/synthetic.terrain_scene, 328,050
    triangles, renderer.bidirectional at 256 x 128, 4 + 4 bounces: the
    wide kernels) and terrain_de_24_bdpt (write_terrain_de_scene, a mesh
    with a Mandelbulb, at the same settings: the wide kernels and the DE
    march). ``small``: the films at 64 x 64, 128 x 64 and 64 x 32, and
    terrain_24_bdpt (1,152 triangles) for terrain_405_bdpt, for quick
    checks. Returns {name: .lua path}."""
    sys.path.insert(0, ROOT)
    from tools.synthetic import terrain_scene

    size = (64, 64, 128, 64, 24) if small else (512, 512, 512, 256, 405)
    out = {"cornell_class": write_cornell_scene(directory, *size[:2], spp=spp)}
    for name, b, lb in (("flagship_bdpt", 8, 8), ("flagship_bdpt_24", 8, 24),
                        ("flagship_bdpt_deep", 16, 8), ("flagship_bdpt_64", 64, 8),
                        ("flagship_bdpt_256", 256, 8)):
        out[name] = write_flagship_bdpt(directory, name, b, lb, *size[2:4])
    cells = size[4]
    terrain = terrain_scene(directory, cells=cells, width=size[2] // 2 if small else 256,
                            height=size[3] // 2 if small else 128, spp=spp, bounces=4)[0]
    name = f"terrain_{cells}_bdpt"
    out[name] = os.path.join(directory, name + ".lua")
    with open(terrain) as fh, open(out[name], "w") as dst:
        dst.write(_bdpt_text(fh.read(), 4, 4))
    # a directory of its own: write_terrain_de_scene writes terrain_24.lua
    mixed_dir = os.path.join(directory, "terrain_de_bdpt")
    os.makedirs(mixed_dir, exist_ok=True)
    mixed = write_terrain_de_scene(mixed_dir, width=size[2] // 2, height=size[3] // 2, spp=spp)
    out["terrain_de_24_bdpt"] = os.path.join(mixed_dir, "terrain_de_24_bdpt.lua")
    with open(mixed) as fh, open(out["terrain_de_24_bdpt"], "w") as dst:
        dst.write(_bdpt_text(fh.read(), 4, 4))
    return out


def _bdpt_setup(path, seed):
    """The bidirectional renderer's first chunk of a scene as render() runs
    it on the card (all rows where they fit, bidirectional.
    pick_rows_per_chunk): (scene, film, camera, cfg, lamp cfg, keyed draws,
    (positions, origin, direction, wavelengths), program values)."""
    from pyrite_tpu_torch import kernels_dense as kd
    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import bidirectional as bd
    from pyrite_tpu_torch.renderers.simple import chunk_rays
    from pyrite_tpu_torch.rng import KeyedDraws
    from pyrite_tpu_torch.tracer import TraceConfig

    scene, film, camera, cfg = _gpu_scene(path)
    light_bounces = load_project(path).project.renderer.light_bounces
    rows = bd.pick_rows_per_chunk(film, light_bounces, cfg.spectrum_samples)
    keyed = KeyedDraws(seed)
    rays = chunk_rays(film, camera, cfg, keyed, rows=rows, device=scene.device)
    lamp_cfg = TraceConfig(light_bounces, 0, cfg.spectrum_samples, cfg.max_de_steps)
    return scene, film, camera, cfg, lamp_cfg, keyed, rays, kd.precompute_bank_values(scene, rays[3])


def _close_where(ref, got, keys, where, what):
    """Vectors within rtol 1e-3 / atol 1e-4 on the lanes ``where``; returns
    the largest absolute error."""
    err = 0.0
    for k in keys:
        diff = (ref[k] - got[k]).abs()
        ok = diff <= 1e-4 + 1e-3 * ref[k].abs()
        if diff.dim() > 1:
            ok, diff = ok.all(dim=-1), diff.amax(dim=-1)
        bad = int((~ok & where).sum())
        assert bad == 0, f"{what}: {k} off on {bad} lanes (max {float(diff[where].max())})"
        if bool(where.any()):
            err = max(err, float(diff[where].max()))
    return err


def _flags_equal(ref, got, keys, what, where=None):
    for k in keys:
        differ = ref[k] != got[k]
        if where is not None:
            differ &= where
        bad = int(differ.sum())
        assert bad == 0, f"{what}: {k} differs on {bad} lanes"


def _compare_vertex(ref, got, what, uv=False):
    """A lamp vertex and the walk's next state: validity and alive exact on
    every lane, the other flags exact where the vertex is valid, vectors
    within rtol 1e-3 / atol 1e-4 there, uv too where ``uv`` (a scene whose
    programs read it, scene.frames). Returns the largest error."""
    ref_v, ref_s = ref
    got_v, got_s = got
    valid = ref_v["valid"]
    _flags_equal(ref_v, got_v, ("valid",), what)
    _flags_equal(ref_s, got_s, ("alive",), what)
    _flags_equal(ref_v, got_v, ("is_diffuse", "dispersed", "color_prog"), what, valid)
    keys = ("position", "normal", "probability", "brdf") + (
        ("brdf_scatter",) if "brdf_scatter" in ref_v else ()) + (("uv",) if uv else ())
    err = _close_where(ref_v, got_v, keys, valid, what)
    return max(err, _close_where(ref_s, got_s, ("origin", "direction"), ref_s["alive"], what))


def check_lamp_walk(name, scene, lamp_cfg, wl, keyed, bank):
    """B on one lamp walk of ``wl``'s lanes with ``keyed``'s draws, each
    step from the plain state against its plain version (_compare_vertex:
    a flag that differs on any lane fails): the start mode against
    tracer.lamp_start, the first bounce from sparse_lamp_state
    (check_sparse_lamp), every lamp bounce against
    tracer.lamp_bounce_step. Returns (the largest error, the plain
    vertices, their incident directions, each depth's (state, draws), the
    start draws)."""
    from pyrite_tpu_torch import kernels_dense as kd, rng, tracer

    n, dev = wl.shape[0], wl.device
    start = rng.lamp_start_draws(keyed, n, scene.num_lamps, dev)
    got = kd.lamp_start(scene, wl, start, bank)
    vertex, state = tracer.lamp_start(scene, wl, start)
    worst = _compare_vertex((vertex, state), got, f"{name} lamp start", scene.frames)
    worst = max(worst, check_sparse_lamp(name, scene, lamp_cfg, wl, state, keyed, bank))
    verts, incident, states = [vertex], [state["direction"]], []
    for d in range(lamp_cfg.bounces):
        draws = rng.lamp_bounce_draws(keyed, n, d, dev)
        states.append((dict(state), draws))
        got_s, got_v = kd.lamp_bounce(scene, lamp_cfg, wl, state, draws, bank)
        incident.append(state["direction"])
        state, vertex = tracer.lamp_bounce_step(scene, lamp_cfg, wl, state, draws)
        worst = max(worst, _compare_vertex((vertex, state), (got_v, got_s), f"{name} lamp bounce {d}",
                                           scene.frames))
        verts.append(vertex)
    return worst, verts, incident, states, start


def check_bdpt(name, path, seed=0, cut=None):
    """Phase 3 for the bidirectional renderer's kernels on one scene, at the
    wavefront render() launches (its first chunk; ``cut`` keeps its first
    lanes): from the same state and draws, each against its plain version
    on CUDA tensors, each step started from the plain state:
    B, the lamp kernel's start mode against tracer.lamp_start and its
    bounces against tracer.lamp_bounce_step (a flag that differs on any
    lane fails), also from a sparse state (check_lamp_walk); A, the bounce
    kernel's kRecord instantiation with the NEE
    kernel (kernels_dense.bounce_dense, record) against
    tracer.bounce_core(record=True) for the camera bounces: the state as
    check_kernels holds it, the camera vertex's flags exact on every lane
    and its position, normal and BRDF factor within rtol 1e-3 / atol 1e-4
    on the diffuse vertices that connections read; and
    kernels_dense.shadow_query (C, dense_shadow_kernel, on a dense scene;
    wide_shadow_kernel on a mesh scene; after the query march pass on a
    scene with DE shapes) bit for bit against shadow_query_plain on the
    connection batch of camera bounce 0, on the splat batch of the plain
    lamp paths and on shadow_edge_batches in their box
    (check_shadow_edges). The plain versions march the
    DE shapes in march_de_kernel (kernel_march). Returns the worst errors
    and the inputs of the timed launches."""
    with kernel_march():
        return _check_bdpt(name, path, seed, cut)


def _check_bdpt(name, path, seed, cut):
    import torch

    from pyrite_tpu_torch import kernels_dense as kd, rng, tracer
    from pyrite_tpu_torch.renderers import bidirectional as bd

    scene, film, camera, cfg, lamp_cfg, keyed, rays, bank = _bdpt_setup(path, seed)
    positions, origin, direction, wl = (r[:cut] for r in rays)
    if cut is not None:
        bank = kd.precompute_bank_values(scene, wl)
    n = wl.shape[0]
    worst = {"lamp": 0.0, "record": 0.0, "brightness": 0.0, "divergent": 0.0}

    dev = scene.device
    worst["lamp"], verts, incident, states, start = check_lamp_walk(name, scene, lamp_cfg, wl, keyed,
                                                                    bank)
    timed = {"lamp": states[0] if states else None, "lamps": states, "start": start}

    cam = tracer.initial_state(origin, direction, wl.shape[1])
    timed["record"] = None
    infos = []
    for b in range(cfg.bounces):
        draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, b, dev)
        if b == 0:
            timed["record"] = (dict(cam), draws)
        out, info = kd.bounce_dense(scene, cfg, wl, cam, draws, bank, record=True)
        plain, plain_info = tracer.bounce_core(scene, cfg, wl, cam, draws, record=True)
        vec_err, b_err, share = _compare(plain, out, f"{name} camera bounce {b}")
        _flags_equal(plain_info, info, ("is_diffuse", "dispersed", "recorded", "miss"),
                     f"{name} camera vertex {b}")
        rec_err = _close_where(plain_info, info, ("position", "normal", "brdf_stored"),
                               plain_info["is_diffuse"], f"{name} camera vertex {b}")
        worst["record"] = max(worst["record"], vec_err, rec_err)
        worst["brightness"] = max(worst["brightness"], b_err)
        worst["divergent"] = max(worst["divergent"], share)
        infos.append((plain, plain_info))
        cam = plain

    result = {"worst": worst, "timed": timed, "setup": (scene, cfg, lamp_cfg, wl, bank)}
    # the plain lamp paths' connection arrays (trace_lamp_path's stacking)
    path_rec = {k: torch.stack([v[k] for v in verts], dim=1) for k in tracer.LAMP_VERTEX}
    path_rec["incident_out"] = torch.stack(incident, dim=1)
    path_rec["brdf_limit"] = verts[-1]["brdf_scatter"]
    path_rec["length"] = path_rec["valid"].sum(dim=1).to(torch.int32)
    if any(p.uses_ray_inputs for p in scene.color_programs):
        # the lamp vertices' colors: program_colors_kernel against the
        # plain programs, at the reversed incident directions
        inc = torch.cat([-path_rec["incident_out"][:, 1:], path_rec["incident_out"][:, -1:]], dim=1)
        colors = (path_rec["color_prog"], path_rec["valid"], path_rec["normal"], inc,
                  path_rec["uv"], wl)
        _zero_counts()
        got_c = kd.vertex_colors(scene, *colors, bank)
        assert _read_counts()["program_colors_kernel"] == 1
        want_c = kd.vertex_colors_plain(scene, *colors)
        worst["colors"] = _close_where({"c": want_c}, {"c": got_c}, ("c",), path_rec["valid"],
                                       f"{name} lamp vertex colors")
        timed["colors"] = colors
        print(f"[bdpt] {name} lamp vertex colors: {int(path_rec['valid'].sum())} valid of "
              f"{path_rec['valid'].numel()} vertices, program_colors_kernel max abs err "
              f"{worst['colors']:.3g} (rtol 1e-3, atol 1e-4)")
    conn = bd._connection_arrays(scene, path_rec, wl, rng.splat_draws(
        keyed, n, lamp_cfg.bounces + 1, dev), bank)
    plain0, info0 = infos[0]
    query, _ = bd._conn_query(info0, conn["position"], conn["normal"], conn["conn_ok"])
    conn_batch = (query["origin"], query["direction"], query["max_dist"], query["block_below"],
                  query["contributes"])
    _, s_origin, s_dir, s_dist, s_mask = bd._splat_query(camera, conn)
    splat_batch = (s_origin, s_dir, s_dist, s_dist - tracer.DIST_EPSILON, s_mask)
    shadow_k = "wide_shadow_kernel" if scene.use_clusters else "dense_shadow_kernel"
    for what, batch in (("connection", conn_batch), ("splat", splat_batch)):
        _zero_counts()
        got_t = kd.shadow_query(scene, cfg, *batch)
        counts = _read_counts()
        assert counts[shadow_k] == 1 and counts["de_query_pass"] == int(bool(scene.de_shapes)) \
            and counts["intersect_shadow"] == 0, counts
        want_t = kd.shadow_query_plain(scene, cfg, *batch)
        bad = int(_bits_differ(want_t, got_t).sum())
        live = int(batch[4].sum())
        blocked = float((got_t < batch[3])[batch[4]].float().mean()) if live else 0.0
        print(f"[bdpt] {name} {what} batch: {batch[0].shape[0]} rays, {live} live, blocked "
              f"share {blocked:.4f}; {shadow_k} t differs from the plain version's on {bad} rays")
        assert live > 0 and bad == 0, f"{name}: the {what} batch's t differs on {bad} of {live} rays"
    timed["shadow"] = conn_batch
    timed["splat"] = splat_batch
    ends = torch.cat([query["origin"][query["contributes"]], s_origin[s_mask]])
    check_shadow_edges(name, scene, cfg, (ends.amin(dim=0).tolist(), ends.amax(dim=0).tolist()))
    print(f"[bdpt] {name}: {n} lanes, S={wl.shape[1]}, {cfg.bounces} + {lamp_cfg.bounces} "
          f"bounces: lamp kernel max abs err {worst['lamp']:.3g}; bounce kernel <record> max abs "
          f"err {worst['record']:.3g} (state and camera vertex), brightness "
          f"{worst['brightness']:.3g}, divergent lanes {worst['divergent']:.4%} (flags exact, "
          f"rtol 1e-3, atol 1e-4)")
    return result


EDGE_BATCHES = ("all_dead", "all_live", "last_thread", "ragged")
# boxes for shadow_edge_batches' rays where no batch of a render gives one:
# the Cornell box's inside, and the flagship's balls and the ground below
EDGE_BOXES = {"cornell_class": ((-2.9, 0.1, -2.9), (2.9, 5.9, 2.9)),
              "flagship_bdpt": ((-5.0, -0.5, 6.0), (5.0, 3.5, 14.0))}


def shadow_edge_batches(box, device="cpu", seed=0, block=128):
    """Hand-built shadow-query batches at the edges of dense_shadow_kernel's
    compaction of live rays, from a numpy seed: {name: (origin, direction,
    max_dist, block_below, live)} on ``device``. Each ray runs from a point
    of the box ``box`` ((lo, hi) corners) toward another, max_dist the
    distance between them and block_below DIST_EPSILON short of it, as the
    connections make them:

    - all_dead: 4 blocks of ``block`` rays, none live;
    - all_live: 4 blocks, every ray live;
    - last_thread: 4 blocks, only the last ray of each block live (its
      block's thread 0 takes it);
    - ragged: 4 blocks and 77 rays (M not a multiple of the block), live in
      runs of 5 as in an [N, K] connection batch (every slot of a dead lane
      dead) and on half the slots of the other lanes.
    """
    import numpy as np
    import torch

    lo, hi = np.asarray(box[0], np.float64), np.asarray(box[1], np.float64)
    out = {}
    for i, name in enumerate(EDGE_BATCHES):
        rng = np.random.default_rng(seed + 211 * i)
        m = 4 * block + (77 if name == "ragged" else 0)
        start, end = rng.uniform(lo, hi, (m, 3)), rng.uniform(lo, hi, (m, 3))
        dist = np.linalg.norm(end - start, axis=1)
        direction = (end - start) / dist[:, None]
        idx = np.arange(m)
        live = {"all_dead": np.zeros(m, bool), "all_live": np.ones(m, bool),
                "last_thread": idx % block == block - 1,
                "ragged": np.repeat(rng.random(m // 5 + 1) < 0.6, 5)[:m] & (rng.random(m) < 0.5)}[name]
        f32 = lambda x: torch.as_tensor(x.astype(np.float32), device=device)  # noqa: E731
        out[name] = (f32(start), f32(direction), f32(dist), f32(dist - 1e-4),
                     torch.as_tensor(live, device=device))
    return out


def check_shadow_edges(name, scene, cfg, box, seed=0):
    """kernels_dense.shadow_query on shadow_edge_batches in the box ``box``
    of the scene, bit for bit against shadow_query_plain (the CPU tests
    hold the plain version to the JAX package's intersect_shadow on such
    batches), each launch counted; on CUDA tensors inside kernel_march.
    Returns the rays checked."""
    from pyrite_tpu_torch import kernels_dense as kd

    shadow_k = "wide_shadow_kernel" if scene.use_clusters else "dense_shadow_kernel"
    rays = 0
    for what, batch in shadow_edge_batches(box, scene.device, seed).items():
        _zero_counts()
        got = kd.shadow_query(scene, cfg, *batch)
        counts = _read_counts()
        assert counts[shadow_k] == 1 and counts["intersect_shadow"] == 0, counts
        bad = int(_bits_differ(kd.shadow_query_plain(scene, cfg, *batch), got).sum())
        live = int(batch[4].sum())
        print(f"[bdpt-edges] {name} {what}: {batch[0].shape[0]} rays, {live} live; {shadow_k} t "
              f"differs from the plain version's on {bad} rays")
        assert bad == 0, f"{name}: edge batch {what}'s t differs on {bad} rays"
        rays += batch[0].shape[0]
    return rays


def sparse_lamp_state(state, every=37):
    """A lamp walk's state with only every ``every``-th lane left alive
    (where it was)."""
    import torch

    alive = state["alive"]
    keep = torch.arange(alive.shape[0], device=alive.device) % every == 0
    return dict(state, alive=alive & keep)


def dead_lamp_lanes(state, vertex, nxt, what):
    """The lanes of ``state`` that are not alive hold what a lamp bounce
    writes for them: the vertex at the ray's origin, normal 0, colour -1,
    probability 0, every flag false, brdf and brdf_scatter 1, uv 0, and the
    next state's ray unchanged, not alive. Returns their count."""
    import torch

    dead = ~state["alive"].bool()
    want = {"position": state["origin"], "normal": 0.0, "uv": 0.0, "color_prog": -1,
            "probability": 0.0, "is_diffuse": False, "dispersed": False, "valid": False,
            "brdf": 1.0, "brdf_scatter": 1.0}
    for k, v in want.items():
        got = vertex[k][dead]
        ref = v[dead] if torch.is_tensor(v) else torch.full_like(got, v)
        assert torch.equal(got, ref), f"{what}: a dead lane's {k} is not {v if not torch.is_tensor(v) else 'its origin'}"
    for k in ("origin", "direction"):
        assert torch.equal(nxt[k][dead], state[k][dead]), f"{what}: a dead lane's next {k} moved"
    assert not bool(nxt["alive"][dead].any()), f"{what}: a dead lane came alive"
    return int(dead.sum())


def check_sparse_lamp(name, scene, lamp_cfg, wl, state, keyed, bank):
    """The lamp kernel's first bounce from sparse_lamp_state(``state``)
    (one lane in 37 alive), against tracer.lamp_bounce_step as
    _compare_vertex holds the others, and its dead lanes against
    dead_lamp_lanes. Returns the largest error."""
    from pyrite_tpu_torch import kernels_dense as kd, rng, tracer

    sparse = sparse_lamp_state(state)
    draws = rng.lamp_bounce_draws(keyed, wl.shape[0], 0, wl.device)
    _zero_counts()
    got_s, got_v = kd.lamp_bounce(scene, lamp_cfg, wl, sparse, draws, bank)
    assert _read_counts()[kd._lamp_name(scene)] == 1
    want_s, want_v = tracer.lamp_bounce_step(scene, lamp_cfg, wl, sparse, draws)
    err = _compare_vertex((want_v, want_s), (got_v, got_s), f"{name} sparse lamp bounce", scene.frames)
    dead = dead_lamp_lanes(sparse, got_v, got_s, f"{name} sparse lamp bounce")
    print(f"[bdpt] {name} sparse lamp state: {int(sparse['alive'].sum())} alive lanes of "
          f"{wl.shape[0]}, max abs err {err:.3g}; the {dead} dead lanes hold their defaults")
    return err


def _once_ms(fn):
    """Milliseconds of one call of ``fn``, host clock around a synchronise."""
    import torch

    torch.cuda.synchronize()
    started = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - started) * 1e3


def _prog_tables_bytes(scene):
    """Bytes a kProg launch reads once besides the program code: its
    textures and frame tables."""
    return _program_bytes(scene) + _nbytes(*(scene.arrays[k] for k in (
        "tri_q", "tri_uv", "sph_texscale", "pla_quat", "pla_texscale")))


def _lamp_cost(scene, lamp_cfg, wl, lamp, draws):
    """(bytes, FP32 operations) of one lamp kernel launch on this run's
    inputs: a bounce of the state ``lamp`` with its LAMP_BOUNCE ``draws``,
    or the start mode where ``lamp`` is None. Bytes, each read or written
    once: the scene sheet; a bounce lane's ray and flag in (25) and its
    vertex and next state out (68; on a kProg scene 8 more of uv, the
    program and frame tables once and each alive lane's leaves), an alive
    lane's four draws, hero wavelength and n_de march t (20 + 4 n_de); a
    start lane its six draws in (24) and its vertex and state out (64).
    Operations: an alive lane's sweep and shading (and frame) and the work
    the plain version counts without its march; a start lane's lamp sample."""
    import torch

    from pyrite_tpu_torch import tracer

    n = wl.shape[0]
    sheet = _nbytes(scene.dense_pack["tensors"]["sheet"])
    prog = scene.dense_pack["prog"]
    if lamp is None:
        return sheet + n * (24 + 64 + (8 if prog else 0)), n * OPS["lamp"]
    alive = torch.nonzero(lamp["alive"])[:, 0]
    size = sheet + n * (25 + 68) + alive.numel() * (20 + 4 * len(scene.de_shapes))
    if prog:
        size += _prog_tables_bytes(scene) + 8 * n + _surface_leaf_bytes(
            scene, lamp_cfg, wl, lamp, draws["u_comp"], color=False)
    with kernel_march():
        work = _counted(lambda: tracer.lamp_bounce_step(
            scene, lamp_cfg, wl[alive], {k: v[alive] for k, v in lamp.items()},
            {k: draws[k][alive] for k in ("u_comp", "u_scatter")}))
    frame = OPS["frame"] if prog else 0
    return size, _work_ops(scene, work, alive.numel(), _sweep_ops(scene) + OPS["shade"] + frame)


def _shadow_cost(scene, cfg, batch):
    """(bytes, FP32 operations) of dense_shadow_kernel on the shadow batch
    ``batch`` (shadow_query's arguments but the scene's). Bytes: the sheet
    once, per live ray 33 (origin, direction, distance and flag in, t out;
    a dense sweep reads no occlusion bound) and n_de t on a DE scene, per
    ray that is not live 9 (flag and distance in, t out). Operations: the
    live rays' sweeps and the work the plain version counts without its
    march."""
    import torch

    from pyrite_tpu_torch import tracer

    live = torch.nonzero(batch[4])[:, 0]
    m = batch[0].shape[0]
    size = (_nbytes(scene.dense_pack["tensors"]["sheet"])
            + live.numel() * (33 + 4 * len(scene.de_shapes)) + (m - live.numel()) * 9)
    with kernel_march():
        work = _counted(lambda: tracer.intersect_shadow(
            scene, batch[0][live], batch[1][live], batch[2][live], batch[3][live],
            cfg.max_de_steps))
    return size, _work_ops(scene, work, live.numel(), _sweep_ops(scene))


def time_bdpt(checked, card, variant=None):
    """Phase 4 for the bidirectional renderer's kernels on one scene
    (check_bdpt's result on a dense scene): per-launch ms of A (the bounce
    kernel's kRecord instantiation at camera bounce 0, against
    tracer.bounce_core(record) without NEE), B (the lamp kernel at lamp
    depth 0, against tracer.lamp_bounce_step) and C (dense_shadow_kernel on
    the connection batch of camera bounce 0, against shadow_query_plain),
    each kernel alone, reading the march passes' t on a DE scene, as
    time_kernels times the bounce kernel (the plain versions once each:
    their DE march takes seconds a call); with the bytes each must move and
    the FP32 operations its rays need (the marches out of them). Returns
    {name: (kernel ms, plain ms, bytes, operations)}. With ``variant``, a
    (name, library) of build_variants, the kernels of that library alone:
    {name: ms}."""
    import dataclasses

    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd, tracer

    scene, cfg, lamp_cfg, wl, bank = checked["setup"]
    n, s_count = wl.shape
    lib = variant[1] if variant else _build.load()
    de = bool(scene.de_shapes)
    cam, cam_draws = checked["timed"]["record"]
    lamp, lamp_draws = checked["timed"]["lamp"]
    t_cam = kd.march_pass(scene, cfg, cam) if de else None
    a_args, _, _, _ = kd.bounce_kernel_args(scene, cfg, wl, cam, cam_draws, bank, t_cam, record=True)
    t_lamp = kd.march_pass(scene, lamp_cfg, lamp) if de else None
    b_args, _, _ = kd.lamp_kernel_args(scene, wl, lamp_draws["words"], bank, lamp, t_lamp)
    batch = checked["timed"]["shadow"]
    t_q = None
    if de:
        q_args, t_q = kd.query_pass_args(scene, cfg, batch[0], batch[1], batch[2], batch[4])
        lib.pyrite_de_march_query_shadow(*q_args)
    c_args, _ = kd.dense_shadow_args(scene, *batch, t_q)
    record = kd._named(scene, "dense_bounce_kernel<record>")
    lamp_name = kd._lamp_name(scene)
    cfg_no_nee = dataclasses.replace(cfg, light_samples=0)
    runs = {
        record: lambda: getattr(lib, kd._LAUNCHERS[record])(*a_args),
        lamp_name: lambda: getattr(lib, kd._LAUNCHERS[lamp_name])(*b_args),
        "dense_shadow_kernel": lambda: lib.pyrite_dense_shadow(*c_args),
    }
    plains = {
        record: lambda: tracer.bounce_core(scene, cfg_no_nee, wl, cam, cam_draws, record=True),
        lamp_name: lambda: tracer.lamp_bounce_step(scene, lamp_cfg, wl, lamp, lamp_draws),
        "dense_shadow_kernel": lambda: kd.shadow_query_plain(scene, cfg, *batch),
    }
    colors = checked["timed"].get("colors")
    if colors is not None:
        v_args, _ = kd.vertex_colors_args(scene, *colors, bank)
        runs["program_colors_kernel"] = lambda: lib.pyrite_program_colors(*v_args)
        plains["program_colors_kernel"] = lambda: kd.vertex_colors_plain(scene, *colors)
    # the plain versions march the DE shapes with PyTorch ops, seconds a
    # call on the card: each is timed once, the kernels as _time_pairs does
    times = {}
    for key in runs:
        for _ in range(2):
            runs[key]()
        torch.cuda.synchronize()
        k1, k2 = _event_ms(runs[key], 50), _event_ms(runs[key], 50)
        if variant:
            times[key] = (k1 + k2) / 2
            print(f"[prog] variant {variant[0]} bdpt {key}: {k1:.4f} / {k2:.4f} ms per launch, {n} "
                  f"lanes ({card})")
            continue
        plain_ms = _once_ms(plains[key])
        times[key] = ((k1 + k2) / 2, plain_ms)
        print(f"[times] {key}: kernel {k1:.4f} / {k2:.4f} ms, plain {plain_ms:.4f} ms (one call) per "
              f"launch, {n} lanes, S={s_count} ({card})")
    if variant:
        return times
    # A, B, C and D: the bytes each must move and the operations they need
    costs = {record: _record_cost(scene, cfg, wl, cam, cam_draws, False),
             lamp_name: _lamp_cost(scene, lamp_cfg, wl, lamp, lamp_draws),
             "dense_shadow_kernel": _shadow_cost(scene, cfg, batch)}
    if colors is not None:
        costs["program_colors_kernel"] = _colors_cost(scene, colors)
    result = {}
    for name in runs:
        size, ops = costs[name]
        result[name] = (*times[name], size, ops)
        print(f"[work] bdpt {name}: {size} bytes, {ops} FP32 operations")
    _print_bounds("bdpt", result)
    return result


def render_bdpt(path, samples, card, out_dir, regen=False):
    """Phase 5 for the bidirectional renderer: the CLI on the GPU
    (renderers.bidirectional.render), checking the PNG, the film, and that
    every step went through the CUDA kernels: per camera bounce iteration
    (of the one-shot walk, or of a regen walk) one launch of the bounce
    kernel's kRecord instantiation and one of the NEE kernel (a march and a
    shadow march pass each on a DE scene), per lamp trace (a chunk step's,
    or a regen launch's round or batch of rounds) one lamp kernel launch to
    start the lamp paths and one per lamp bounce iteration (a march pass
    each on a DE scene), and the connection and splat batches through
    dense_shadow_kernel or wide_shadow_kernel (a query march pass each on a
    DE scene); no plain tracer function ran. ``regen``: the render must take
    the regen scheduler (else it must not), compacting every lamp trace.
    Prints the launches, the camera and lamp lane-bounces, the rays (camera
    and lamp lane-bounces, NEE samples, connection and splat rays), the
    regen walks' iterations and flushes, the render's wall time and peak
    memory. Returns (launch counts, seconds, peak bytes, rays)."""
    import numpy as np
    import torch
    from PIL import Image

    from pyrite_tpu_torch import cli, kernels_dense as kd
    from pyrite_tpu_torch.renderers import bidirectional as bd

    result = {}
    render = bd.render

    def recording_render(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        started = time.perf_counter()
        film, acc, wt = render(*args, **kwargs)
        torch.cuda.synchronize()
        result.update(film=film, acc=acc, wt=wt, seconds=time.perf_counter() - started,
                      peak=torch.cuda.max_memory_allocated())
        return film, acc, wt

    out_png = os.path.join(out_dir, os.path.basename(path) + ".bdpt.png")
    bd.render = recording_render
    _zero_counts()
    try:
        rc = cli.main([path, "--samples", str(samples), "--device", "cuda", "--output", out_png])
    finally:
        bd.render = render
    launches = _read_counts()
    assert rc == 0, f"cli.main returned {rc}"
    film, acc, wt = result["film"], result["acc"], result["wt"]
    assert bool(torch.isfinite(acc).all() and torch.isfinite(wt).all()), "film is not finite"
    with Image.open(out_png) as img:
        pixels = np.asarray(img)
    assert pixels.shape == (film.height, film.width, 3) and pixels.max() > 0, pixels.shape
    scene = _gpu_scene(path)[0]
    r = cli.load_project(path).project.renderer
    bounce_k, nee_k = kd.kernel_names(scene)
    record_k = kd._named(scene, ("wide" if scene.use_clusters else "dense") + "_bounce_kernel<record>")
    cam, lamp = launches["camera_bounces"], launches["lamp_bounces"]
    steps, traces = launches["steps"], launches["lamp_traces"]
    assert (launches["regen_bdpt_walks"] > 0) == regen and (steps == 0) == regen, launches
    assert cam > 0 and launches[record_k] == cam and launches[nee_k] == cam, launches
    assert launches[bounce_k] == 0, launches
    lamp_k = kd._lamp_name(scene)
    assert launches[lamp_k] == traces + lamp > traces, launches
    colors = any(p.uses_ray_inputs for p in scene.color_programs)
    assert launches["program_colors_kernel"] == (traces if colors else 0), launches
    for k in ("bounce_core", "lamp_start", "lamp_bounce_step", "intersect_shadow"):
        assert launches[k] == 0, (k, launches)
    queries = launches["wide_shadow_kernel" if scene.use_clusters else "dense_shadow_kernel"]
    assert queries >= traces + cam, launches  # the splats, and each bounce's slot groups
    if scene.de_shapes:
        assert launches["de_march_pass"] == cam + lamp and launches["de_shadow_pass"] == cam, launches
        assert launches["de_query_pass"] == queries, launches
    if regen:
        assert launches["regen_bdpt_iterations"] == cam and launches["compactions"] == traces, launches
    elif r.light_bounces + 1 > 16:
        assert launches["compactions"] == steps, launches
    rays = (launches["live_lane_bounces"] * (1 + r.light_samples) + launches["lamp_live"]
            + launches["connection_rays"] + launches["splat_rays"])
    print(
        f"[bdpt-render] {os.path.basename(path)} {film.width}x{film.height}, {samples} spp, "
        f"S={r.spectrum_samples}, {r.bounces} + {r.light_bounces} bounces "
        f"({_bdpt_schedule(launches, r)}): render wall "
        f"{result['seconds']:.4f} s, peak memory {result['peak'] / 2**20:.1f} MiB, "
        f"{rays / result['seconds'] / 1e6:.3f} Mrays/s ({rays} rays: camera lane-bounces live "
        f"{launches['live_lane_bounces']} x (1 + {r.light_samples} NEE), executed "
        f"{launches['executed_lane_bounces']}; lamp lane-bounces live {launches['lamp_live']}, "
        f"executed {launches['lamp_executed']}; connection rays {launches['connection_rays']}, "
        f"splat rays {launches['splat_rays']}) ({card}); launches {launches}; image mean "
        f"{pixels.mean():.2f}/255"
    )
    return launches, result["seconds"], result["peak"], rays


def _bdpt_schedule(launches, r):
    """How a bidirectional render ran, from its counts."""
    if launches["regen_bdpt_walks"]:
        return (f"regen: {launches['regen_bdpt_launches']} launches, {launches['regen_bdpt_walks']} walks, "
                f"{launches['regen_bdpt_iterations']} iterations, {launches['regen_bdpt_flushes']} flushes, "
                f"{launches['lamp_traces']} lamp traces, {launches['regen_bdpt_stray_scatters']} "
                f"stray scatters")
    return "two-phase" if r.light_bounces + 1 > 16 else "fused"


class regen_bdpt_from:
    """Within the block, renderers.bidirectional.render takes the regen
    scheduler from ``bounces`` camera bounces on (REGEN_BDPT_MIN_BOUNCES):
    1 on every scene, None on none (the one-shot step)."""

    def __init__(self, bounces):
        self.bounces = 10**6 if bounces is None else bounces

    def __enter__(self):
        from pyrite_tpu_torch.renderers import bidirectional as bd

        self.saved, bd.REGEN_BDPT_MIN_BOUNCES = bd.REGEN_BDPT_MIN_BOUNCES, self.bounces
        return self

    def __exit__(self, *exc):
        from pyrite_tpu_torch.renderers import bidirectional as bd

        bd.REGEN_BDPT_MIN_BOUNCES = self.saved


class kernel_march:
    """Within the block the plain versions march the DE shapes in
    march_de_kernel (kernels.march_de) rather than in PyTorch ops
    (tracer.march_de_plain, whose per-iteration launches take seconds a
    call on the card): the same t bit for bit (phase 3, check_march), so
    a plain version's results do not change, and the BDPT checks of a DE
    scene take seconds rather than minutes."""

    def __enter__(self):
        import torch

        from pyrite_tpu_torch import kernels, tracer

        self.saved = tracer.march_de_plain
        if torch.cuda.is_available():  # kernels.march_de takes the plain march on the CPU
            tracer.march_de_plain = kernels.march_de
        return self

    def __exit__(self, *exc):
        from pyrite_tpu_torch import tracer

        tracer.march_de_plain = self.saved


class plain_bdpt:
    """Within the block the bidirectional renderer's steps take their
    plain versions on CUDA tensors (the camera bounce, the lamp start and
    bounces, the shadow queries): the reference a kernel render is held
    to on the card."""

    def __enter__(self):
        from pyrite_tpu_torch import kernels_dense as kd, tracer

        self.saved = {k: getattr(kd, k) for k in ("bounce_dense", "lamp_start", "lamp_bounce",
                                                    "shadow_query")}
        kd.bounce_dense = lambda scene, cfg, wl, state, draws, bank, record=False, chain=False: \
            tracer.bounce_core(scene, cfg, wl, state, draws, record)
        kd.lamp_start = lambda scene, wl, draws, bank=None: tracer.lamp_start(scene, wl, draws)
        kd.lamp_bounce = lambda scene, cfg, wl, state, draws, bank=None: \
            tracer.lamp_bounce_step(scene, cfg, wl, state, draws)
        kd.shadow_query = kd.shadow_query_plain
        return self

    def __exit__(self, *exc):
        from pyrite_tpu_torch import kernels_dense as kd

        for k, v in self.saved.items():
            setattr(kd, k, v)


class kernel_sampler:
    """Within the block the plain versions draw uniform sphere directions
    as the kernels do (csrc/bounce.cu sample_sphere_dir: cos phi = 2 v - 1
    and sin phi = sqrt(1 - cos^2 phi), where geometry.sample_sphere takes
    the cos and sin of arccos(2 v - 1)), op for op: the kernels' one
    intended difference from the plain versions, taken out."""

    def __enter__(self):
        import math

        import torch

        from pyrite_tpu_torch import geometry

        def sample_sphere(u, v):
            theta = 2.0 * math.pi * u
            cos_phi = torch.clamp(2.0 * v - 1.0, -1.0, 1.0)
            sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
            return torch.stack(
                [sin_phi * torch.cos(theta), sin_phi * torch.sin(theta), cos_phi], dim=-1)

        self.saved = geometry.sample_sphere
        geometry.sample_sphere = sample_sphere
        return self

    def __exit__(self, *exc):
        from pyrite_tpu_torch import geometry

        geometry.sample_sphere = self.saved


def compare_bdpt_plain(path, samples, card):
    """Phase 6: one bidirectional render through the kernels and through
    the plain versions on the card (plain_bdpt, marching in
    march_de_kernel: kernel_march), with the same keyed draws, held per
    pixel (summed over its bins): against the plain versions that sample
    directions as the kernels do (kernel_sampler), wt within rtol 1e-5 and
    acc within rtol 1e-3 on every pixel; against the plain versions as
    they are, the film totals within rtol 1e-4 (wt) and 1e-3 (acc) and the
    per-pixel tolerances on at least 98 % of the pixels. The kernels'
    arccos-free sphere directions differ from geometry.sample_sphere's in
    a last ulp, which a chain of bounces carries to the odd grazing hit
    and splat: on the Cornell class at 64 x 64, 2 spp, 4 + 4 bounces, 1.5 %
    of the pixels part from the plain film as it is, none from the plain
    film with the kernels' sampling, and the same holds with the glass
    sphere and the Julia taken out (measured on one NVIDIA H100 80GB
    HBM3, 700.00 W). Returns (the largest per-pixel relative differences
    of wt and acc against the plain versions with the kernels' sampling,
    then as they are, and the shares of pixels beyond the tolerance
    there)."""
    import torch

    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import bidirectional as bd

    scene = _gpu_scene(path)[0]
    pd = load_project(path)
    _zero_counts()
    _, acc_k, wt_k = bd.render(pd, scene, seed=6, max_samples=samples)
    assert _read_counts()["bounce_core"] == 0 or scene.device.type == "cpu"
    ak, wk = acc_k.sum(dim=2), wt_k.sum(dim=2)
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp_min(1e-30))  # noqa: E731
    films = {}
    for sampling in ("the kernels' sampling", "as they are"):
        with plain_bdpt(), kernel_march(), (kernel_sampler() if sampling != "as they are"
                                            else contextlib.nullcontext()):
            _, acc_p, wt_p = bd.render(pd, scene, seed=6, max_samples=samples)
        assert _read_counts()["bounce_core"] > 0
        ap, wp = acc_p.sum(dim=2), wt_p.sum(dim=2)
        wt_off = float((rel(wk, wp) > 1e-5).float().mean())
        acc_off = float((rel(ak, ap) > 1e-3).float().mean())
        films[sampling] = (float(rel(wk, wp).max()), float(rel(ak, ap).max()), wt_off, acc_off)
        print(f"[bdpt] {os.path.basename(path)} {samples} spp, kernels against the plain versions "
              f"({sampling}) on the card: per pixel wt max rel {films[sampling][0]:.3e} "
              f"({wt_off:.4%} of pixels beyond 1e-5; total {float(wp.sum()):.1f} against "
              f"{float(wk.sum()):.1f}), acc max rel {films[sampling][1]:.3e} ({acc_off:.4%} beyond "
              f"1e-3; total {float(ap.sum()):.3f} against {float(ak.sum()):.3f}) ({card})")
        if sampling != "as they are":
            torch.testing.assert_close(wk, wp, rtol=1e-5, atol=0.0)
            torch.testing.assert_close(ak, ap, rtol=1e-3, atol=0.0)
        else:
            assert wt_off < 0.02 and acc_off < 0.02, (wt_off, acc_off)
            torch.testing.assert_close(wk.sum(), wp.sum(), rtol=1e-4, atol=0.0)
            torch.testing.assert_close(ak.sum(), ap.sum(), rtol=1e-3, atol=0.0)
    return films["the kernels' sampling"][:2] + films["as they are"]


class regen_probe:
    """Within the block, the first regen BDPT walk iteration whose
    wavefront holds both regenerated lanes and lanes at depth >= 1 (read
    from the lane draws it makes: the regenerated lanes take camera draws,
    every lane draws at its own depth) holds its kernels against their
    plain versions on the card, on the same inputs: A with the NEE kernel
    (kernels_dense.bounce_dense, record) against
    tracer.bounce_core(record=True) with check_bdpt's tolerances (the state
    as _compare holds it with no divergent lane, the camera vertex's flags
    exact on every lane, its position, normal and BRDF factor within rtol
    1e-3 / atol 1e-4 on the diffuse vertices), and C
    (kernels_dense.shadow_query) bit for bit against shadow_query_plain on
    the iteration's connection batch, each lane against its own round. The
    render itself goes on with the kernels' results."""

    def __init__(self, name):
        self.name, self.result, self.pending = name, None, None

    def __enter__(self):
        from pyrite_tpu_torch import kernels_dense as kd
        from pyrite_tpu_torch.renderers import bidirectional as bd

        self.saved = (bd.lane_draws, kd.bounce_dense, bd._connect_fold_grouped)
        bd.lane_draws, kd.bounce_dense = self._draws, self._bounce
        bd._connect_fold_grouped = self._fold
        self.iteration = 0
        return self

    def __exit__(self, *exc):
        from pyrite_tpu_torch import kernels_dense as kd
        from pyrite_tpu_torch.renderers import bidirectional as bd

        bd.lane_draws, kd.bounce_dense, bd._connect_fold_grouped = self.saved

    def _draws(self, keys, s, light_samples, num_lamps, mask, dev):
        if self.result is None and self.pending is None:
            deep = ~mask & (keys.depth >= 1)
            if bool(mask.any()) and bool(deep.any()):
                picked = keys.sample[mask]
                self.pending = {"iteration": self.iteration, "regenerated": int(mask.sum()),
                                "deep": int(deep.sum()), "max_depth": int(keys.depth.max()),
                                "samples": (int(keys.sample.min()), int(keys.sample.max())),
                                "regenerated_samples": (int(picked.min()), int(picked.max()))}
        self.iteration += 1
        return self.saved[0](keys, s, light_samples, num_lamps, mask, dev)

    def _bounce(self, scene, cfg, wl, state, draws, bank, record=False, chain=False):
        from pyrite_tpu_torch import tracer

        out = self.saved[1](scene, cfg, wl, state, draws, bank, record, chain)
        if self.pending is not None and "record" not in self.pending and record:
            what = f"{self.name} regen iteration {self.pending['iteration']}"
            with kernel_march():
                plain, plain_info = tracer.bounce_core(scene, cfg, wl, state, draws, record=True)
            vec_err, b_err, share = _compare(plain, out[0], what)
            assert share == 0.0, f"{what}: {share:.4%} divergent lanes"
            _flags_equal(plain_info, out[1], ("is_diffuse", "dispersed", "recorded", "miss"), what)
            rec_err = _close_where(plain_info, out[1], ("position", "normal", "brdf_stored"),
                                   plain_info["is_diffuse"], what)
            self.pending.update(record=max(vec_err, rec_err), brightness=b_err,
                                live=int(state["alive"].sum()), lanes=state["alive"].shape[0])
        return out

    def _fold(self, scene, cfg, info, state, conn, conn_vsum, conn_cnt):
        from pyrite_tpu_torch import kernels_dense as kd
        from pyrite_tpu_torch.renderers import bidirectional as bd

        if self.pending is not None and "record" in self.pending:
            query, _ = bd._conn_query(info, conn["position"], conn["normal"], conn["conn_ok"])
            batch = (query["origin"], query["direction"], query["max_dist"], query["block_below"],
                     query["contributes"])
            got = kd.shadow_query(scene, cfg, *batch)
            with kernel_march():
                want = kd.shadow_query_plain(scene, cfg, *batch)
            bad, live = int(_bits_differ(want, got).sum()), int(batch[4].sum())
            assert live > 0 and bad == 0, f"{self.name}: the regen connection batch's t differs " \
                                          f"on {bad} of {live} rays"
            self.result = dict(self.pending, rays=batch[0].shape[0], live_rays=live,
                               slots=conn["conn_ok"].shape[1])
            self.pending = None
        return self.saved[2](scene, cfg, info, state, conn, conn_vsum, conn_cnt)


def check_regen_bdpt(name, path, samples, card):
    """Phase 6, the regen BDPT scheduler at the slice's width: one render
    of ``path`` through it (bidirectional.render's dispatch, the scene's
    16 camera bounces) with regen_probe checking the kernels at a regen
    wavefront (from 2 samples: a lane regenerates after its first), and
    one through the one-shot step (regen_bdpt_from(None)), the same seed: the
    films to the CPU tests' tolerance (tests/test_torch_regen_bdpt.py), wt
    within rtol 1e-6 and acc within rtol 1e-4 / atol 1e-6. Prints the
    probe's wavefront and errors and each render's wall, iterations,
    flushes, lane-bounces and peak memory. Returns the probe's result (None
    at 1 sample)."""
    import torch

    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import bidirectional as bd

    scene = _gpu_scene(path)[0]
    pd = load_project(path)
    films, probe = {}, regen_probe(name)
    for which in ("regen", "one-shot"):
        with (probe if which == "regen" else contextlib.nullcontext()), regen_bdpt_from(
                bd.REGEN_BDPT_MIN_BOUNCES if which == "regen" else None):
            _zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            started = time.perf_counter()
            _, acc, wt = bd.render(pd, scene, seed=11, max_samples=samples)
            torch.cuda.synchronize()
            wall = time.perf_counter() - started
            launches = _read_counts()
        assert (launches["regen_bdpt_walks"] > 0) == (which == "regen"), launches
        # (the probe's plain versions run in the regen render)
        assert launches["bounce_core"] == 0 or which == "regen" or scene.device.type == "cpu"
        films[which] = (acc, wt)
        print(f"[regen-bdpt] {name} {samples} spp through {which} "
              f"({_bdpt_schedule(launches, pd.project.renderer)}): wall {wall:.4f} s, camera "
              f"bounce launches {launches['camera_bounces']}, {_lanes_line(launches)}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")
    result = probe.result
    assert (result is not None) == (samples > 1), f"{name}: the probe's wavefront {result}"
    if result is not None:
        _print_probe(name, result, card)
    (acc_r, wt_r), (acc_o, wt_o) = films["regen"], films["one-shot"]
    rel = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())  # noqa: E731
    print(f"[regen-bdpt] {name} regen film against one-shot: wt max rel {rel(wt_r, wt_o):.3e}, acc "
          f"max rel {rel(acc_r, acc_o):.3e}, max abs {float((acc_r - acc_o).abs().max()):.3e} "
          f"(wt total {float(wt_r.sum()):.1f} against {float(wt_o.sum()):.1f})")
    assert float(wt_o.sum()) > 0
    torch.testing.assert_close(wt_r, wt_o, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(acc_r, acc_o, rtol=1e-4, atol=1e-6)
    return result


def _print_probe(name, result, card):
    print(f"[regen-bdpt] {name} regen iteration {result['iteration']}: {result['live']} live of "
          f"{result['lanes']} lanes, {result['regenerated']} regenerated, {result['deep']} at depth "
          f">= 1 (up to {result['max_depth']}), samples {result['samples'][0]}..{result['samples'][1]} "
          f"in flight (the regenerated lanes' {result['regenerated_samples'][0]}.."
          f"{result['regenerated_samples'][1]}), each lane at its own round's wavelengths; A with "
          f"NEE max abs err "
          f"{result['record']:.3g} (state and camera vertex), brightness {result['brightness']:.3g}, "
          f"no divergent lane; C: {result['rays']} connection rays ({result['slots']} slots a lane), "
          f"{result['live_rays']} live, t bit for bit ({card})")


def regen_bdpt_step(bdpt, cornell_64, card, out_dir):
    """Phase 6's regen BDPT step: check_regen_bdpt on flagship_bdpt_deep at
    4 spp, then four CLI renders through the regen scheduler with the
    counts zeroed just before each (render_bdpt): flagship_bdpt_deep (its
    16 camera bounces take it), and forced (REGEN_BDPT_MIN_BOUNCES = 1)
    the 64 x 64 Cornell class (the DE march), terrain_405_bdpt at 1 spp
    (the wide kernels) and flagship_bdpt_24 (a lamp trace a round).
    Returns (the probe's result, the renders' launch counts)."""
    started = time.perf_counter()
    result = check_regen_bdpt("flagship_bdpt_deep", bdpt["flagship_bdpt_deep"], 4, card)
    runs = [render_bdpt(bdpt["flagship_bdpt_deep"], 4, card, out_dir, regen=True)[0]]
    with regen_bdpt_from(1):
        runs += [render_bdpt(p, spp, card, out_dir, regen=True)[0] for p, spp in (
            (cornell_64, 2), (bdpt["terrain_405_bdpt"], 1), (bdpt["flagship_bdpt_24"], 2))]
    print(f"[phase] regen BDPT (phase 6): {time.perf_counter() - started:.1f} s")
    return result, runs


# --- phase 7: the photon renderer -------------------------------------------------

PHOTON_EXTRA = "photons = %d, photon_bounces = %d, photon_passes = %d, radius = %s,"


def photon_scene_paths(directory, small=False):
    """Phase 7's photon-mapping projects: flagship_photon
    (__graft_entry__._SCENE_SRC with renderer.photon_mapping at 512 x 256,
    S = 6, 8 bounces, 2 light samples; 100,000 photons of 8 bounces, 2
    passes, radius 0.1, the reference's default radius, SURVEY.md section 2;
    every color program reads only the wavelength: exact mode) and
    textures_photon (write_textures_scene's textures scene at 256 x 192, S
    = 6, 4 bounces, with 100,000 photons of 4 bounces, one pass, radius 0.1:
    its programs read the ray, so interpolation mode, a camera walk of S + G
    = 70 columns and a lamp walk of 65 through the kProg kernels).
    ``small``: 64 x 32 and 64 x 48 films and 4,000 photons, for quick checks.
    Returns {name: .lua path}."""
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _SCENE_SRC

    os.makedirs(directory, exist_ok=True)
    w, h, photons = (64, 32, 4000) if small else (512, 256, 100_000)
    flagship = (_SCENE_SRC % {"w": w, "h": h, "s": 6, "b": 8}).replace(
        "renderer.simple", "renderer.photon_mapping").replace(
        "bounces = 8,", "bounces = 8, " + PHOTON_EXTRA % (photons, 8, 2, "0.1"), 1)
    out = {"flagship_photon": os.path.join(directory, "flagship_photon.lua")}
    with open(out["flagship_photon"], "w") as fh:
        fh.write(flagship)
    tw, th = (64, 48) if small else (256, 192)
    out["textures_photon"] = write_textures_scene(
        os.path.join(directory, "textures_photon"), tw, th, 6, 4, spp=16, renderer="photon_mapping",
        photon=(photons, 4, 1, 0.1))
    return out


def photon_bins_scene(path, bins):
    """A photon project of photon_scene_paths (flagship_photon) with a film
    of ``bins`` spectral bins, written beside it; its .lua path."""
    with open(path) as fh:
        text = fh.read()
    assert "radius = 0.1," in text, path
    out = path[:-4] + f"_{bins}.lua"
    with open(out, "w") as fh:
        fh.write(text.replace("radius = 0.1,", f"radius = 0.1, spectrum_resolution = {bins},", 1))
    return out


EDGE_MAPS = ("all_valid", "over_cap", "negative", "at_radius", "bins_512")


def gather_edge_maps(device="cpu", seed=0):
    """Hand-built gathers at the edges of the hash grid, from a numpy seed:
    {name: (GatherSpec, photons, query)}, the photons unsorted (photon_batch's
    fields; sorted_map sorts them) and the query as gather_query makes it,
    on ``device``. radius 0.5, 16 bins, K = 3 and G = 8 in interpolation
    mode:

    - all_valid: every photon valid, queries on the photons of the cell of
      the largest key (shorter than _CELL_CAP), where the scan's index
      clips to P - 1 and counts the last photon again;
    - over_cap: 60 photons in one cell (the first _CELL_CAP of it count),
      a quarter of the others invalid;
    - negative: photons and queries at negative coordinates, near the
      origin and at |cell| > 29, where the key's products wrap;
    - at_radius: photons at exactly the radius along an axis (in) and one
      ulp past it (out), the coordinates exact in float32;
    - bins_512: exact mode at 512 bins and K = 6 (a project past the old
      gate's 447), M = 4 colour programs with sign and zero flags.
    """
    import numpy as np
    import torch

    from pyrite_tpu_torch.renderers import photon as ph

    radius, span = 0.5, (400.0, 700.0)
    out = {}
    for i, name in enumerate(EDGE_MAPS):
        rng = np.random.default_rng(seed + 101 * i)
        exact = name == "bins_512"
        bins, k, g, m = (512, 6, 0, 4) if exact else (16, 3, 8, 0)
        spec = ph.GatherSpec(radius, span, bins, k, g, exact, 1 if exact else 1 + bins)
        if name == "all_valid":
            pos = rng.uniform(0.0, 2.0, (300, 3))
            valid = np.ones(300, bool)
        elif name == "over_cap":
            pos = np.concatenate([rng.uniform(0.5, 1.0, (60, 3)), rng.uniform(0.0, 2.5, (200, 3))])
            valid = np.concatenate([np.ones(60, bool), rng.random(200) > 0.25])
        elif name == "negative":
            pos = np.concatenate([rng.uniform(-2.2, 0.3, (200, 3)),
                                  rng.uniform(-0.6, 0.6, (50, 3)) + (-40.3, -25.1, 33.7),
                                  rng.uniform(-0.6, 0.6, (50, 3)) + (36.2, -31.9, -44.4)])
            valid = rng.random(300) > 0.1
        elif name == "at_radius":
            centres = rng.integers(-16, 16, (40, 3)) / 8.0
            axes = np.eye(3)[rng.integers(0, 3, 40)] * rng.choice([-1.0, 1.0], (40, 1))
            at = (centres + radius * axes).astype(np.float32)
            past = np.nextafter(at, (at + axes).astype(np.float32))
            pos = np.concatenate([centres, at, past, rng.uniform(-2.0, 2.0, (80, 3))])
            valid = np.ones(pos.shape[0], bool)
        else:
            pos = rng.uniform(-1.0, 1.5, (400, 3))
            valid = rng.random(400) > 0.1
        p = pos.shape[0]
        pos = pos.astype(np.float32)
        inc = rng.normal(size=(p, 3))
        inc[:, 1] = -np.abs(inc[:, 1]) * np.where(rng.random(p) < 0.9, 1.0, -1.0)
        inc /= np.linalg.norm(inc, axis=1, keepdims=True)
        photons = {"position": pos, "incident": inc,
                   "power": rng.uniform(0.1, 1.0, (p, spec.power_cols)),
                   "wavelength": rng.uniform(*span, p), "valid": valid,
                   "dispersed": rng.random(p) < 0.2}
        # the queries: on photons (the largest key's cell first), then
        # between them
        keys = ph.grid_sort_photons(torch.as_tensor(pos), torch.as_tensor(valid), radius)[1]
        own = ph._hash_cells(torch.as_tensor(pos), radius)[0].numpy()
        last = np.flatnonzero(valid & (own == int(keys[valid.sum() - 1])))
        n = 96
        at = np.concatenate([last, rng.choice(np.flatnonzero(valid), n - len(last) - 32)])
        if name == "at_radius":
            at = np.arange(n - 32) % 40  # the exact centres
        q_pos = np.concatenate([pos[at], pos[rng.integers(0, p, 32)] + rng.uniform(-0.3, 0.3, (32, 3))])
        normal = rng.normal(size=(n, 3)) * 0.2 + (0.0, 1.0, 0.0)
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        q_inc = rng.normal(size=(n, 3)) * 0.3 - normal
        q_inc /= np.linalg.norm(q_inc, axis=1, keepdims=True)
        q = {"position": q_pos.astype(np.float32), "normal": normal, "incident": q_inc,
             "valid": rng.random(n) > 0.1, "dispersed": rng.random(n) < 0.2,
             "partialR": rng.uniform(0.1, 1.0, (n, k + g)), "lam0": rng.uniform(*span, n),
             "lam_f": rng.uniform(*span, (n, k))}
        if exact:
            for side, rows in ((photons, (p,)), (q, (n,))):
                side["counts"] = rng.integers(0, 3, rows + (m,)).astype(np.float32)
                side["scalar"] = rng.uniform(0.2, 1.0, rows)
            for suffix, rows in (("_f", (p,)), ("_f0", (n,)), ("_ff", (n, k))):
                side = photons if suffix == "_f" else q
                side["log" + suffix] = np.log(rng.uniform(0.2, 1.0, rows + (m,)))
                side["neg" + suffix] = (rng.random(rows + (m,)) < 0.2).astype(np.float32)
                side["zero" + suffix] = (rng.random(rows + (m,)) < 0.03).astype(np.float32)

        def tensors(d):
            return {key: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32)).to(device)
                    for key, v in d.items()}

        out[name] = (spec, tensors(photons), tensors(q))
    return out


def sorted_map(photons, spec):
    """A photon map of hand-built photons: build_map's sort and gather
    (grid_sort_photons), the exact mode's factors taken as given."""
    from pyrite_tpu_torch.renderers import photon as ph

    order, keys = ph.grid_sort_photons(photons["position"], photons["valid"], spec.radius)
    return dict({k: v[order].contiguous() for k, v in photons.items()}, keys=keys.contiguous())


def _photon_setup(path, seed):
    """The photon renderer's first chunk of a project as render() runs it,
    one sample: (project, scene, parts (photon._build_parts), rows, photon
    map of pass 0, its draws, the camera draws, the chunk's rays, its walk's
    wavelengths [N, S + G] and program values)."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd, rng
    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import photon as ph
    from pyrite_tpu_torch.renderers.simple import chunk_rays
    from pyrite_tpu_torch.rng import KeyedDraws

    pd = load_project(path)
    scene = _gpu_scene(path)[0]
    settings = pd.project.renderer
    parts = ph._build_parts(pd, scene)
    film, camera, cfg, photon_cfg, spec, _, _, grid_centers, bin_centers = parts
    rows = ph.pick_rows_per_chunk(film, ph.lane_bytes(scene, settings, spec), scene.texture_bytes
                                  + ph.map_bytes(settings, spec, len(scene.color_programs)))
    passes = settings.photon_passes
    cam_draws = KeyedDraws(seed, sample0=0)
    photon_draws = KeyedDraws(seed, sample0=1)
    lam_p = rng.photon_wavelengths(photon_draws, settings.photons, spec.span, scene.device)
    pm = ph.build_map(scene, ph.photon_batch(scene, photon_cfg, photon_draws, lam_p, spec,
                                             bin_centers), spec)
    rays = chunk_rays(film, camera, cfg, cam_draws, rows=rows, device=scene.device)
    wl = rays[3]
    n = wl.shape[0]
    wl_ext = wl if spec.exact else torch.cat(
        [wl, grid_centers[None, :].expand(n, spec.g_bins)], dim=1).contiguous()
    assert passes >= 1
    return (pd, scene, parts, rows, pm, photon_draws, cam_draws, rays, wl_ext,
            kd.precompute_bank_values(scene, wl_ext))


def _occupancy_line(keys):
    from pyrite_tpu_torch.renderers import photon as ph

    biggest, cells, over = (int(x) for x in ph.cell_occupancy(keys))
    return (f"largest cell {biggest} photons, {cells} cells, {over} past the cap of "
            f"{ph._CELL_CAP} (share {over / max(cells, 1):.6f})")


def check_record_chain(name, path, seed=0, setup=None):
    """The camera walk of a photon project's first chunk through the
    bounce kernels' kRecord instantiation with its chain factors
    (kernels_dense.bounce_dense, record and chain) against
    tracer.bounce_core(record=True), on CUDA tensors, each bounce from the
    plain state: the vertex's flags exact on every lane, color_prog exact and
    position, normal, BRDF factor, color_prob and path_prob within rtol 1e-3
    / atol 1e-4 on the lanes that reflect. The plain version marches DE
    shapes in march_de_kernel (kernel_march). Returns the largest error."""
    from pyrite_tpu_torch import kernels_dense as kd, tracer

    (pd, scene, parts, rows, pm, photon_draws, cam_draws, rays, wl_ext,
     bank) = setup or _photon_setup(path, seed)
    cfg = parts[2]
    _, origin, direction, wl = rays
    n = wl.shape[0]
    worst, reflecting = 0.0, 0
    state = tracer.initial_state(origin, direction, wl_ext.shape[1])
    with kernel_march():
        for i in range(cfg.bounces):
            if not bool(state["alive"].any()):
                break
            what = f"{name} camera bounce {i}"
            draws = tracer.draw_bounce_uniforms(scene, cfg, n, cam_draws, i, scene.device)
            _, got = kd.bounce_dense(scene, cfg, wl_ext, state, draws, bank, record=True, chain=True)
            state, ref = tracer.bounce_core(scene, cfg, wl_ext, state, draws, record=True)
            _flags_equal(ref, got, ("reflected", "is_diffuse", "dispersed", "recorded", "miss"), what)
            refl = ref["reflected"]
            reflecting += int(refl.sum())
            _flags_equal(ref, got, ("color_prog",), what, refl)
            worst = max(worst, _close_where(
                ref, got, ("position", "normal", "brdf_stored", "color_prob", "path_prob"), refl,
                what))
    assert reflecting > 0, f"{name}: no lane reflects"
    return worst


def check_photon(name, path, seed=0):
    """Phase 7's checks on one photon project at the wavefront render()
    launches (its first chunk, sample 0, pass 0), on CUDA tensors: the
    camera walk's chain factors (check_record_chain), the photon walk's
    lamp kernel (check_lamp_walk on pass 0's photons), then
    photon_gather_kernel against its plain version (renderers.photon.
    gather_plain) on every bounce of the kernels' walk against the map of
    pass 0 (the lamp kernels' photons): num_neighbors and fresh_cnt equal,
    acc_bins, cnt_bins and fresh_psum within rtol 1e-5 / atol 1e-7 (the same
    adds in the same order; CUDA's expf and PyTorch's exp may differ in the
    last ulp). Prints the map's cell occupancy. Returns the worst errors and
    the inputs of the timed gather (camera bounce 0)."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd, rng
    from pyrite_tpu_torch.renderers import photon as ph

    setup = _photon_setup(path, seed)
    (pd, scene, parts, rows, pm, photon_draws, cam_draws, rays, wl_ext, bank) = setup
    film, camera, cfg, photon_cfg, spec = parts[:5]
    _, origin, direction, wl = rays
    n = wl.shape[0]
    dev = scene.device
    worst = {"record": check_record_chain(name, path, seed, setup), "gather": 0.0}
    # the photon walk's lamp kernel (photon_batch's inputs of pass 0)
    settings = pd.project.renderer
    lam_p = rng.photon_wavelengths(photon_draws, settings.photons, spec.span, dev)
    wl_p = lam_p if spec.exact else torch.cat(
        [lam_p, parts[8][None, :].expand(lam_p.shape[0], spec.bins)], dim=1)
    with kernel_march():
        worst["lamp"] = check_lamp_walk(f"{name} photons", scene, photon_cfg, wl_p, photon_draws,
                                        kd.precompute_bank_values(scene, wl_p))[0]
    # the gather, on the kernels' own walk
    chain_m = len(scene.color_programs) if spec.exact else None
    _, vertices = ph._record_camera_vertices(scene, cfg, cam_draws, origin, direction, wl_ext, bank,
                                             chain_m)
    lam0 = wl_ext[:, 0].contiguous()
    factors0 = ph._log_factors(scene, lam0) if spec.exact else None
    timed = None
    pairs = 0
    for b, vertex in enumerate(vertices):
        lam_f, _ = rng.fresh_wavelengths(photon_draws, n, b, spec.spectrum_samples, spec.span, dev)
        q = ph.gather_query(scene, vertex, spec, lam0, lam_f, factors0)
        got = kd.photon_gather(spec, pm, q)
        ref = ph.gather_plain(spec, pm, q)
        err, same = _hold_gather(f"{name} gather at camera bounce {b}", got, ref)
        worst["gather"] = max(worst["gather"], err)
        equal = [(e + e2, n + n2) for (e, n), (e2, n2) in zip(equal, same)] if b else same
        pairs += int(ref["cnt_bins"].sum())
        if b == 0:
            timed = (q, ref)
    assert pairs > 0, f"{name}: no photon gathered"
    print(f"[photon] {name}: {n} lanes ({rows} rows), S + G = {wl_ext.shape[1]} columns "
          f"({'exact' if spec.exact else 'interpolation'} mode), {pm['keys'].shape[0]} map entries; "
          f"record fields and gather against the plain version on {len(vertices)} bounces: "
          f"largest errors {worst}, {pairs} pairs; {_bit_equal(equal)}; "
          f"{_occupancy_line(pm['keys'])}")
    return {"worst": worst, "setup": (scene, spec, pm), "timed": timed}


_HELD = ("acc_bins", "cnt_bins", "fresh_psum")


def _hold_gather(what, got, ref):
    """photon_gather_kernel's outputs ``got`` against gather_plain's ``ref``:
    num_neighbors and fresh_cnt equal, acc_bins, cnt_bins and fresh_psum
    within rtol 1e-5 / atol 1e-7 (the same adds in the same order; CUDA's
    expf and PyTorch's exp may differ in the last ulp). Returns (the largest
    error, [(entries bit-equal, entries)] of those three)."""
    for k in ("num_neighbors", "fresh_cnt"):
        bad = int((got[k] != ref[k]).sum())
        assert bad == 0, f"{what}: {k} differs on {bad} lanes"
    worst, same = 0.0, []
    for k in _HELD:
        diff = (got[k] - ref[k]).abs()
        bad = int((diff > 1e-7 + 1e-5 * ref[k].abs()).sum())
        assert bad == 0, f"{what}: {k} off on {bad} entries (max {float(diff.max())})"
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        same.append((int((got[k] == ref[k]).sum()), ref[k].numel()))
    return worst, same


def _bit_equal(same):
    return "bit-equal to the plain version: " + ", ".join(
        f"{k} {e} of {n}" for k, (e, n) in zip(_HELD, same))


def check_gather_edges(card, seed=0):
    """photon_gather_kernel against its plain version on the hand-built
    maps of gather_edge_maps (the CPU tests hold the plain version to the
    JAX package's enumeration on the same maps), as _hold_gather holds
    them; every map must pass the gate (kernels_dense.gather_smem_bytes).
    Returns the largest error."""
    from pyrite_tpu_torch import kernels_dense as kd
    from pyrite_tpu_torch.renderers import photon as ph

    worst = 0.0
    for name, (spec, photons, q) in gather_edge_maps("cuda", seed).items():
        smem = kd.gather_smem_bytes(spec.bins, spec.spectrum_samples)
        assert smem <= kd.SMEM_PER_BLOCK, f"edge map {name}: B={spec.bins} is past the gate"
        pm = sorted_map(photons, spec)
        got, ref = kd.photon_gather(spec, pm, q), ph.gather_plain(spec, pm, q)
        err, same = _hold_gather(f"edge map {name}", got, ref)
        worst = max(worst, err)
        print(f"[photon-edges] {name}: {q['position'].shape[0]} lanes, {pm['keys'].shape[0]} map "
              f"entries, B={spec.bins}, K={spec.spectrum_samples}, "
              f"{'exact' if spec.exact else 'interpolation'} mode: "
              f"{int(ref['num_neighbors'].sum())} within the radius, largest error {err}; "
              f"{_bit_equal(same)}; {_occupancy_line(pm['keys'])} ({card})")
    return worst


def _gather_work(spec, pm, q, out):
    """(bytes, FP32 operations) of one gather, counted as this run's data
    needs them. Bytes, each read or written once: every map key (the
    binary searches); the valid flag of each photon that a valid lane's
    candidate reads touch (the key matches its cell, up to _CELL_CAP) and
    the other fields of those that are valid; every lane's valid flag and
    the other query rows of the valid lanes, the fresh wavelengths' rows
    (lam_f and, in exact mode, their factors) only of lanes with a fresh
    pair; every output. Operations: the binary searches (ceil(log2(P + 1))
    steps of each valid lane's 27 cells), every candidate read (the cell's
    photons up to _CELL_CAP and the read that ends it), every pair (its
    geometry and two chain values: a re-walk of M factors, or an
    interpolation) and every fresh wavelength of a pair where neither
    dispersed."""
    import math

    import torch

    from pyrite_tpu_torch.renderers import photon as ph

    def row_bytes(v):
        return _nbytes(v) // max(v.shape[0], 1)

    valid = q["valid"]
    p = pm["keys"].shape[0]
    starts, ckeys = ph.grid_query(pm["keys"], q["position"], spec.radius)
    ends = torch.searchsorted(pm["keys"], ckeys.reshape(-1), right=True).reshape(ckeys.shape)
    taken = torch.clamp(ends - starts, max=ph._CELL_CAP)
    lo, hi = starts[valid].reshape(-1).long(), (starts + taken)[valid].reshape(-1).long()
    mark = torch.zeros(p + 1, dtype=torch.int64, device=lo.device)
    mark.index_add_(0, lo, torch.ones_like(lo))
    mark.index_add_(0, hi, -torch.ones_like(hi))
    touched = mark.cumsum(0)[:p] > 0
    live = touched & pm["valid"]
    n_touched, n_live = int(touched.sum()), int(live.sum())
    n_valid = int(valid.sum())
    n_fresh = int(((out["fresh_cnt"] > 0) & valid).sum())
    fresh_rows = ("lam_f", "log_ff", "neg_ff", "zero_ff")
    size = (_nbytes(pm["keys"]) + n_touched * row_bytes(pm["valid"])
            + n_live * sum(row_bytes(v) for k, v in pm.items() if k not in ("keys", "valid"))
            + _nbytes(valid)
            + n_valid * sum(row_bytes(v) for k, v in q.items() if k != "valid" and k not in fresh_rows)
            + n_fresh * sum(row_bytes(q[k]) for k in fresh_rows if k in q)
            + sum(_nbytes(v) for v in out.values()))
    reads = int(torch.clamp(ends - starts + 1, max=ph._CELL_CAP)[valid].sum())
    searches = n_valid * 27 * math.ceil(math.log2(p + 1))
    pairs, fresh = int(out["cnt_bins"].sum()), int(out["fresh_cnt"].sum())
    m = pm["log_f"].shape[1] if spec.exact else 0
    chain = OPS["chain_factor"] * m + OPS["chain"] if spec.exact else OPS["interp"]
    ops = (searches * OPS["search_step"] + reads * OPS["candidate"]
           + pairs * (OPS["pair"] + 2 * chain) + fresh * spec.spectrum_samples * (chain + 2))
    print(f"[work] photon_gather_kernel: {n_valid} valid lanes of {valid.shape[0]} ({n_fresh} with a "
          f"fresh pair) x 27 cells x {math.ceil(math.log2(p + 1))} search steps, {reads} candidate "
          f"reads touching {n_touched} of {p} map entries ({n_live} valid photons), "
          f"{int(out['num_neighbors'].sum())} within the radius, {pairs} pairs, {fresh} fresh pairs "
          f"x {spec.spectrum_samples}; {size} bytes, {ops} FP32 operations")
    return size, ops


def time_photon(checked, card, plain_reps=1):
    """Phase 4 for photon_gather_kernel: ms per launch at camera bounce 0 of
    check_photon's chunk (two windows of 20 launches) and its plain version
    (one call), with the bytes and operations its inputs need
    (_gather_work). Returns {"photon_gather_kernel": (kernel ms, plain ms,
    bytes, operations)}."""
    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd
    from pyrite_tpu_torch.renderers import photon as ph

    scene, spec, pm = checked["setup"]
    q, ref = checked["timed"]
    args, _ = kd.photon_gather_args(spec, pm, q)
    lib = _build.load()
    run = lambda: lib.pyrite_photon_gather(*args)  # noqa: E731
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    k1, k2 = _event_ms(run, 20), _event_ms(run, 20)
    plain_ms = sum(_once_ms(lambda: ph.gather_plain(spec, pm, q)) for _ in range(plain_reps)) / plain_reps
    n = q["position"].shape[0]
    print(f"[times] photon_gather_kernel: kernel {k1:.4f} / {k2:.4f} ms, plain {plain_ms:.4f} ms "
          f"(one call) per launch, {n} lanes, {pm['keys'].shape[0]} map entries, B={spec.bins}, "
          f"K={spec.spectrum_samples} ({card})")
    size, ops = _gather_work(spec, pm, q, ref)
    result = {"photon_gather_kernel": ((k1 + k2) / 2, plain_ms, size, ops)}
    _print_bounds("photon", result)
    return result


def render_photon(path, samples, card, out_dir):
    """Phase 7's render: the CLI on the GPU (renderers.photon.render),
    checking the PNG, the film, and that every step went through the CUDA
    kernels: per camera bounce iteration one launch of the bounce kernel's
    kRecord instantiation (and of the NEE kernel where the project samples
    lamps), per photon map one lamp kernel launch to start the lamp paths and
    one per lamp bounce iteration, one photon_gather_kernel launch per
    camera bounce and photon pass; no plain tracer function and no plain
    gather ran. Prints the launches, the cell occupancy of its maps, the
    camera and lamp lane-bounces, its wall time and peak memory. Returns
    (launch counts, seconds, peak bytes)."""
    import numpy as np
    import torch
    from PIL import Image

    from pyrite_tpu_torch import cli, kernels_dense as kd
    from pyrite_tpu_torch.renderers import photon as ph

    result = {}
    render = ph.render
    plain = ph.gather_plain

    def recording_render(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        started = time.perf_counter()
        film, acc, wt = render(*args, **kwargs)
        torch.cuda.synchronize()
        result.update(film=film, acc=acc, wt=wt, seconds=time.perf_counter() - started,
                      peak=torch.cuda.max_memory_allocated())
        return film, acc, wt

    def refused(*args, **kwargs):
        raise AssertionError("the render took the plain gather")

    out_png = os.path.join(out_dir, os.path.basename(path) + ".photon.png")
    ph.render, ph.gather_plain = recording_render, refused
    _zero_counts()
    try:
        rc = cli.main([path, "--samples", str(samples), "--device", "cuda", "--output", out_png])
    finally:
        ph.render, ph.gather_plain = render, plain
    launches = _read_counts()
    assert rc == 0, f"cli.main returned {rc}"
    film, acc, wt = result["film"], result["acc"], result["wt"]
    assert bool(torch.isfinite(acc).all() and torch.isfinite(wt).all()), "film is not finite"
    with Image.open(out_png) as img:
        pixels = np.asarray(img)
    assert pixels.shape == (film.height, film.width, 3) and pixels.max() > 0, pixels.shape
    scene = _gpu_scene(path)[0]
    r = cli.load_project(path).project.renderer
    bounce_k, nee_k = kd.kernel_names(scene)
    record_k = kd._named(scene, ("wide" if scene.use_clusters else "dense") + "_bounce_kernel<record>")
    cam, maps = launches["photon_camera_bounces"], launches["maps"]
    assert cam > 0 and launches[record_k] == cam, launches
    assert launches[nee_k] == (cam if r.light_samples and scene.num_lamps else 0), launches
    assert launches[bounce_k] == 0, launches
    assert maps == samples * r.photon_passes, launches
    assert launches[kd._lamp_name(scene)] == maps + launches["lamp_bounces"] > maps, launches
    gather = "photon_gather_kernel" + (
        "<out_row>" if kd.gather_out_row(r.spectrum_bins, r.spectrum_samples) else "")
    assert launches[gather] == launches["gathers"] == cam * r.photon_passes, launches
    for k in ("bounce_core", "lamp_start", "lamp_bounce_step", "intersect_shadow"):
        assert launches[k] == 0, (k, launches)
    print(
        f"[photon-render] {os.path.basename(path)} {film.width}x{film.height}, {samples} spp, "
        f"S={r.spectrum_samples}, {r.bounces} camera bounces, {r.photons} photons x "
        f"{r.photon_passes} passes of {r.photon_bounces} bounces, radius {r.radius}: render wall "
        f"{result['seconds']:.4f} s, peak memory {result['peak'] / 2**20:.1f} MiB; camera "
        f"lane-bounces live {launches['live_lane_bounces']}, executed "
        f"{launches['executed_lane_bounces']}; lamp lane-bounces live {launches['lamp_live']}, "
        f"executed {launches['lamp_executed']}; cells of its {maps} maps: largest "
        f"{launches['max_cell']} photons, {launches['cells_over_cap']} of {launches['cells']} past "
        f"the cap (share {launches['cells_over_cap'] / max(launches['cells'], 1):.6f}) ({card}); "
        f"launches {launches}; image mean {pixels.mean():.2f}/255")
    return launches, result["seconds"], result["peak"]


def photon_step(card):
    """``--photon``: phase 7's gather alone: check_photon and time_photon on
    flagship_photon and textures_photon, then flagship_photon's 2-spp
    render walls (profile_photon)."""
    with tempfile.TemporaryDirectory() as tmp:
        photon = photon_scene_paths(os.path.join(tmp, "photon"))
        for name, path in photon.items():
            time_photon(check_photon(name, path), card)
    profile_photon(card)


def profile_photon(card, runs=5):
    """``--profile``, flagship_photon through renderers.photon.render at 2
    spp: ``runs`` timed runs after a warm-up, then one under
    torch.profiler. Prints the launches, peak memory, wall times, device
    busy time and idle share, and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import photon as ph

    spp = 2
    with tempfile.TemporaryDirectory() as tmp:
        path = photon_scene_paths(tmp)["flagship_photon"]
        scene = _gpu_scene(path)[0]
        project_data = load_project(path)

        def render():
            torch.cuda.synchronize()
            started = time.perf_counter()
            ph.render(project_data, scene, max_samples=spp)
            torch.cuda.synchronize()
            return time.perf_counter() - started

        render()
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        walls = [render()]
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        walls += [render() for _ in range(runs - 1)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = render()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        own = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total  # noqa: E731
        busy = sum(own(e) for e in events) / 1e3
        top = sorted(events, key=own, reverse=True)[:12]
        median = sorted(walls)[len(walls) // 2]
        print(f"[profile-photon] flagship_photon {spp} spp ({card}): launches {launches}; peak "
              f"memory {peak / 2**20:.1f} MiB; render wall s {', '.join(f'{w:.4f}' for w in walls)}; "
              f"median {median:.4f} s")
        print(f"[profile-photon] profiled run: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
              f"idle share {1 - busy / (wall * 1e3):.3f}; top device ops: " + "; ".join(
                  f"{e.key[:60]} {own(e) / 1e3:.3f} ms ({e.count}x)" for e in top))


# --- kernel A in each form, and D, alone (--rows) ------------------------------

# The forms of kernel A (the bounce kernels' kRecord instantiations) as the
# renderers launch them: (label, scene of record_scene_paths, chain factors).
RECORD_FORMS = (
    ("cornell_class <true><record>", "cornell_class", False),
    ("flagship_bdpt <record>", "flagship_bdpt", False),
    ("flagship_photon <record> chain", "flagship_photon", True),
    ("textures_bdpt <record><prog>", "textures_bdpt", False),
    ("textures_photon <record><prog> S + G", "textures_photon", True),
    ("terrain_405_bdpt wide <record>", "terrain_405_bdpt", False),
)
# A's instantiations whose registers, shared memory and resident warps
# print_record_registers prints: since this PR their streamed ones
# (<stream>), in a parent's library the staged ones that ran there
RECORD_KERNELS = ("dense_bounce_kernel<true><record>", "dense_bounce_kernel<false><record>",
                  "dense_bounce_kernel<false><record><prog>", "wide_bounce_kernel<false><record>",
                  "program_colors_kernel")


def record_scene_paths(directory):
    """The scenes of RECORD_FORMS under ``directory``: {name: .lua path}."""
    os.makedirs(directory, exist_ok=True)
    paths = bdpt_scene_paths(directory, spp=2)
    paths["textures_bdpt"] = texture_paths(os.path.join(directory, "textures"))["textures_bdpt"]
    paths.update(photon_scene_paths(os.path.join(directory, "photon")))
    return paths


def record_inputs(path, chain, seed=1):
    """A's inputs on the first chunk of ``path`` as its renderer launches
    it: a photon project's camera walk (``chain``; _photon_setup, at S + G
    columns in interpolation mode), else the bidirectional renderer's
    (_bdpt_setup), at camera bounces 0 and 1 (bounce 1's state from bounce
    0 through the kernels, kernels_dense.bounce_dense with its NEE).
    Returns (scene, cfg, wavelengths, program values, [(state, draws, march
    t) of bounce 0, of bounce 1])."""
    from pyrite_tpu_torch import kernels_dense as kd, tracer

    if chain:
        (_, scene, parts, _, _, _, keyed, rays, wl, bank) = _photon_setup(path, seed)
        cfg = parts[2]
    else:
        scene, _, _, cfg, _, keyed, rays, bank = _bdpt_setup(path, seed)
        wl = rays[3]
    n = wl.shape[0]
    state = tracer.initial_state(rays[1], rays[2], wl.shape[1])
    bounces = []
    for b in range(2):
        draws = tracer.draw_bounce_uniforms(scene, cfg, n, keyed, b, scene.device)
        bounces.append((state, draws, kd.march_pass(scene, cfg, state) if scene.de_shapes else None))
        if b == 0:
            state = kd.bounce_dense(scene, cfg, wl, state, draws, bank, record=True, chain=chain)[0]
    return scene, cfg, wl, bank, bounces


def _record_cost(scene, cfg, wl, state, draws, chain):
    """(bytes, FP32 operations) of one launch of A on this run's inputs.
    Bytes, each read or written once: the scene sheet; per lane the bounce
    kernel's 24 S + 99 and the camera vertex's 32 (position, normal, BRDF
    factor, four flags), 4 n_de of march t on a DE scene and, with the
    photon renderer's ``chain`` factors, 4 S + 9 more (color_prob,
    color_prog, path_prob, reflected); on a kProg scene the program tables,
    textures and frame tables once and each lane's leaf values.
    Operations: each alive lane's sweep and shading (and frame) and the
    work the plain version counts without its march (kernel_march)."""
    import dataclasses

    import torch

    from pyrite_tpu_torch import tracer

    n, s = wl.shape
    prog = scene.dense_pack["prog"]
    size = _nbytes(scene.dense_pack["tensors"]["sheet"]) + n * (
        24 * s + 131 + 4 * len(scene.de_shapes) + ((4 * s + 9) if chain else 0))
    if prog:
        size += _prog_tables_bytes(scene) + _surface_leaf_bytes(scene, cfg, wl, state,
                                                                draws["u_comp"])
    alive = torch.nonzero(state["alive"])[:, 0]
    cfg_no_nee = dataclasses.replace(cfg, light_samples=0)
    with kernel_march():
        work = _counted(lambda: tracer.bounce_core(
            scene, cfg_no_nee, wl[alive], {k: v[alive] for k, v in state.items()},
            {k: draws[k][alive] for k in ("u_comp", "u_scatter")}, record=True))
    frame = OPS["frame"] if prog else 0
    return size, _work_ops(scene, work, alive.numel(), _sweep_ops(scene) + OPS["shade"] + frame)


def _digests(tensors):
    """{name: sha256 of its bytes} of a dict of tensors."""
    import hashlib

    return {k: hashlib.sha256(v.contiguous().cpu().numpy().tobytes()).hexdigest()
            for k, v in tensors.items()}


def _time_libs(what, launcher, args, outputs, libs, order, card):
    """One launcher's kernel through each library of ``libs`` ({name:
    (library, build log)}) in ``order`` on the same arguments: after one
    launch each, the digests of ``outputs`` (the tensors the arguments
    point into), then ms per launch, two windows of 50 after a warm-up.
    Returns ({library: digests}, {library: [ms, ...]})."""
    import torch

    digests, times = {}, {}
    for name in order:
        run = lambda: getattr(libs[name][0], launcher)(*args)  # noqa: E731
        assert run() == 0, f"{what} {name}: launch failed"
        torch.cuda.synchronize()
        digests.setdefault(name, _digests(outputs))
        run()
        torch.cuda.synchronize()
        k1, k2 = _event_ms(run, 50), _event_ms(run, 50)
        times.setdefault(name, []).append((k1 + k2) / 2)
        print(f"[record-rows] {what} {name}: {k1:.4f} / {k2:.4f} ms per launch ({card})")
    return digests, times


def _bound_ms(size, ops):
    by_bytes, by_ops = size / HBM_BYTES_PER_S * 1e3, ops / _fp32_rate() * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def color_edge_batches(scene, n, slots, seed=0, device="cpu"):
    """Hand-built batches of lamp-vertex slots for program_colors_kernel
    and its plain version, n lanes of ``slots`` slots on ``scene``:
    every slot invalid; every slot valid; a valid prefix of each length
    (lane i's first i % (slots + 1)); programs -1 and out of range among
    valid slots (where the scene bakes no table: the JAX package clamps an
    out-of-range index into its table); and a program with code beside one
    without, slot by slot. Programs, normals, incident directions and uv
    drawn from ``seed`` with numpy. Returns {name: (color_prog, valid,
    normal, incident, uv)}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    programs = scene.dense_pack["programs"]
    n_color = len(scene.color_programs)
    code = [c for c in range(n_color) if programs.program_code(programs.index("color", c))]
    plain = [c for c in range(n_color) if c not in code]
    assert code and plain, "the scene needs a colour program with code and one without"
    prog = rng.integers(0, n_color, (n, slots))
    normal = rng.normal(size=(n, slots, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    incident = rng.normal(size=(n, slots, 3))
    incident /= np.linalg.norm(incident, axis=-1, keepdims=True)
    uv = rng.uniform(-1.0, 2.0, (n, slots, 2))
    prefix = np.arange(slots)[None, :] < (np.arange(n) % (slots + 1))[:, None]
    bad = prog.copy()
    pick = rng.integers(0, 3, (n, slots))
    bad[pick == 0] = -1
    if scene.color_bank_bakeable is None:
        bad[pick == 1] = n_color
    beside = np.where((np.arange(n * slots).reshape(n, slots) % 2) == 0,
                      rng.choice(code, (n, slots)), rng.choice(plain, (n, slots)))
    cases = {"all_invalid": (prog, np.zeros((n, slots), bool)),
             "all_valid": (prog, np.ones((n, slots), bool)),
             "prefixes": (prog, prefix),
             "bad_programs": (bad, np.ones((n, slots), bool)),
             "code_beside_none": (beside, rng.uniform(size=(n, slots)) < 0.8)}
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return {name: (torch.as_tensor(p, dtype=torch.int32, device=device),
                   torch.as_tensor(v, device=device), f32(normal), f32(incident), f32(uv))
            for name, (p, v) in cases.items()}


def check_color_edges(name, path, wl, bank, seed=0, slots=5):
    """program_colors_kernel (kernels_dense.vertex_colors) against its
    plain version on color_edge_batches of the scene at ``path`` and of the
    same scene with a baked table (bank_table_min(1)), at the lanes' wavelengths
    ``wl``: each colour within rtol 1e-3 / atol 1e-4 (one launch counted
    each). Returns ({case: (arguments of the timed launch, out, and the
    tensors the arguments point into)}, largest error)."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd

    key = path + "#table"
    if key not in _SCENES:
        with bank_table_min(1):
            _SCENES[key] = load_scene(path)
    found, worst = {}, 0.0
    n = wl.shape[0]
    for which in (path, key):
        scene = _gpu_scene(which)[0]
        b = bank if which == path else kd.precompute_bank_values(scene, wl)
        table = scene.color_bank_bakeable is not None
        for case, batch in color_edge_batches(scene, n, slots, seed, "cuda").items():
            what = f"{name}{' table' if table else ''} {case}"
            _zero_counts()
            got = kd.vertex_colors(scene, *batch, wl, b)
            assert _read_counts()["program_colors_kernel"] == 1, what
            want = kd.vertex_colors_plain(scene, *batch, wl)
            err = _close_where({"c": want}, {"c": got}, ("c",), torch.ones_like(batch[1]), what)
            worst = max(worst, err)
            found[what] = kd.vertex_colors_args(scene, *batch, wl, b) + (batch, b)
            print(f"[colors] {what}: {int(batch[1].sum())} valid of {batch[1].numel()} slots, "
                  f"max abs err {err:.3g} (rtol 1e-3, atol 1e-4)")
    assert next(iter(found.values()))[1].shape == (n, slots, wl.shape[1])
    return found, worst


def print_record_registers(lib, log, what="build"):
    """A's and D's instantiations (RECORD_KERNELS) in library ``lib`` built
    with ``log``: registers, spill stores / loads, shared memory a block
    (static from ptxas -v; dynamic as the launchers pass it at each form's
    S: pyrite_bounce_record_smem, or in a library without it (a parent's)
    the staged rows, plus a kProg scene's program stack of 8 values) and
    resident warps a SM (resident_warps). The record forms at the S of
    RECORD_FORMS: cornell 10, flagship 6, textures_bdpt 6 (the kProg form;
    the same kernel at textures_photon's 70 columns), terrain 4;
    program_colors_kernel at S = 6. Returns {kernel: (registers, stores,
    loads, shared bytes, warps)}."""
    from pyrite_tpu_torch import kernels_dense as kd

    regs, static = kernel_registers(log), kernel_static_smem(log)
    if not regs:
        print(f"[record-regs] {what}: no build log in this process, registers not read")
        return {}
    new = hasattr(lib, "pyrite_bounce_record_smem")
    stack = 16 * kd.BLOCK * 8
    at = {"dense_bounce_kernel<true><record>": (10, 1, kd.FORM_SIMPLE, 0),
          "dense_bounce_kernel<false><record>": (6, 0, kd.FORM_SIMPLE, 0),
          "dense_bounce_kernel<false><record><prog>": (6, 0, kd.FORM_PROG, stack),
          "wide_bounce_kernel<false><record>": (4, 0, kd.FORM_SIMPLE, 0)}
    if new:
        at["dense_bounce_kernel<false><record><prog> at 70"] = (70, 0, kd.FORM_PROG, stack)
    found = {}
    for name in RECORD_KERNELS + (("dense_bounce_kernel<false><record><prog> at 70",) if new else ()):
        label = name.replace(" at 70", "")
        if new and name != "program_colors_kernel":
            label = label + "<stream>" if "<prog>" in label else label.replace("<record>",
                                                                               "<record><stream>")
        if label not in regs:
            continue
        r, st, ld = regs[label]
        if name == "program_colors_kernel":
            dyn = stack + (4 * 4 * 64 if new else 0)  # its warps' rings
        else:
            s_count, de, form, stk = at[name]
            dyn = stk + (lib.pyrite_bounce_record_smem(s_count, de, form) if new
                         else 4 * kd.BLOCK * (4 * s_count + 12) + (kd._DE_SLOT_BYTES if de else 0))
        smem = static.get(label, 0) + dyn
        found[name] = (r, st, ld, smem, resident_warps(r, smem))
    print(f"[record-regs] {what}: registers, spill stores / loads, shared memory a block, resident "
          f"warps a SM: " + "; ".join(f"{k} {r}, {st}/{ld} B, {sm} B, {w}"
                                       for k, (r, st, ld, sm, w) in found.items()))
    return found


def time_record_form(path, chain, card, seed=1):
    """Kernel A in the form ``path``'s renderer launches at camera bounce 0
    (record_inputs; ``chain``: a photon project), alone: ms per launch (two
    windows of 50 after a warm-up) against the plain tracer.bounce_core
    (record=True) without NEE, timed once, and the bytes and operations of
    _record_cost. Returns (ms, plain ms, bytes, operations)."""
    import dataclasses

    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd, tracer

    scene, cfg, wl, bank, bounces = record_inputs(path, chain, seed)
    state, draws, t_de = bounces[0]
    name = kd.record_name(scene)
    args = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank, t_de, True, chain)[0]
    launch = getattr(_build.load(), kd._LAUNCHERS[name])
    run = lambda: launch(*args)  # noqa: E731
    for _ in range(2):
        assert run() == 0, f"{name}: launch failed"
    torch.cuda.synchronize()
    k1, k2 = _event_ms(run, 50), _event_ms(run, 50)
    cfg_no_nee = dataclasses.replace(cfg, light_samples=0)
    with kernel_march():
        plain_ms = _once_ms(lambda: tracer.bounce_core(scene, cfg_no_nee, wl, state, draws, record=True))
    size, ops = _record_cost(scene, cfg, wl, state, draws, chain)
    print(f"[times] {name} on {os.path.basename(path)}: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{plain_ms:.4f} ms (one call) per launch, {wl.shape[0]} lanes, S={wl.shape[1]}; "
          f"{size} bytes, {ops} FP32 operations ({card})")
    result = ((k1 + k2) / 2, plain_ms, size, ops)
    _print_bounds(f"record {os.path.basename(path)}", {name: result})
    return result


# Builds of csrc/bounce.cu that --rows times A and D against (the
# probes). Of A: the camera vertex not written (a_no_vertex), no DE-normal
# probes (a_no_de_normals), no closest-hit sweep of the primitives
# (a_no_sweep), the streamed rows not updated (a_no_rows: bounce_rows
# skipped), the DE form without its launch bound (a_unbounded), and the
# parent's code of A (a_parent_form, A_PARENT_FORM: the record launchers
# pick as the bounce launchers do, staged up to 16 columns and on a kProg
# scene at any S). Of D: program_colors_kernel without its launch bound
# (d_unbounded). Each edit applies to every instantiation it reaches; only
# A's and D's times are read.
A_PARENT_FORM = [[(
    "#define PICK_RECORD(K, DE)                                                                     \\\n"
    "  (form != FORM_PROG ? &K<DE, true, false, true, true>                                         \\\n"
    "   : WIDE            ? &K<DE, true, true, true, true>                                          \\\n"
    "                     : &K<DE, true, true, true, true, true>)\n"
    "#define RECORD_SMEM stream_smem_bytes(n_de > 0, form == FORM_PROG ? OWN_FLOATS(RECORD_STRIDE) : 0)",
    "#define PICK_RECORD(K, DE) \\\n"
    "  (form == FORM_PROG ? &K<DE, true, true, true, false> : PICK_GATE(K, DE, true))\n"
    "#define RECORD_SMEM (form == FORM_PROG ? bounce_smem_bytes(s, n_de > 0) : BOUNCE_SMEM)")]]
RECORD_VARIANTS = {
    "a_no_vertex": [[("    if (kRecord) {\n      const bool miss = alive && !found;",
                      "    if (false) {\n      const bool miss = alive && !found;")]],
    "a_no_de_normals": [[("  if (kDE)\n    de_normals_shared(sh, smem + BLOCK * (kStream ? 12 + ROW_OP_FLOATS",
                          "  if (false)\n    de_normals_shared(sh, smem + BLOCK * (kStream ? 12 + ROW_OP_FLOATS")]],
    "a_no_sweep": [[("  } else if (alive) {\n    h = geo.closest(sh, o, d, true);\n  }\n"
                     "  if (kDE && alive) apply_de_closest(sh, a.t_de, n, lane, h);",
                     "  }\n  if (kDE && alive) apply_de_closest(sh, a.t_de, n, lane, h);")]],
    "a_no_rows": [[("  } else if (kStream) {\n    bounce_rows<kRecord>(a, rec, ops, base, rows);\n  } else {",
                    "  } else if (false) {\n    bounce_rows<kRecord>(a, rec, ops, base, rows);\n  } else if (!kStream) {")],
                  [("  if (kStream) {\n    bounce_rows<kRecord>(a, rec, ops, base, rows);\n  } else {",
                    "  if (false) {\n    bounce_rows<kRecord>(a, rec, ops, base, rows);\n  } else if (!kStream) {")]],
    "a_unbounded": [[("__global__ void __launch_bounds__(BLOCK, 8)\n    dense_bounce_kernel<true, true, false, true, true>",
                      "__global__ void __launch_bounds__(BLOCK)\n    dense_bounce_kernel<true, true, false, true, true>")]],
    "a_parent_form": A_PARENT_FORM,
    "d_unbounded": [[("__launch_bounds__(BLOCK, 8) program_colors_kernel(",
                      "__launch_bounds__(BLOCK) program_colors_kernel(")]],
}


def check_record_form(label, path, chain, libs=None, seed=0):
    """Kernel A in the form ``path``'s renderer launches (record_inputs;
    ``chain``: a photon project, with its chain factors) at camera bounces
    0 and 1, held to the plain version on the same inputs: the bounce
    kernel's kRecord launch and the NEE kernel after it against
    tracer.bounce_core(record=True) as check_kernels holds the state (flags
    exact, vectors rtol 1e-3 / atol 1e-4, no divergent lane), the camera
    vertex's flags exact on every lane and its position, normal, BRDF
    factor (and chain factors) within the tolerance on the lanes that
    reflect. With ``libs`` ({name: (library, log)}, build_variants') each
    library's kRecord launch on the same arguments is digested too.
    Returns ({bounce: {library: digests}}, largest error); the build's
    digests are under "build"."""
    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd, tracer

    scene, cfg, wl, bank, bounces = record_inputs(path, chain, seed)
    launcher = kd._LAUNCHERS[kd.record_name(scene)]
    libs = dict(libs or {}, build=(_build.load(), ""))
    found, worst = {}, 0.0
    for b, (state, draws, t_de) in enumerate(bounces):
        what = f"{label} camera bounce {b}"
        args, out, ctx, info = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank, t_de, True,
                                                     chain)
        outputs = dict(out, **ctx, **{k: v for k, v in info.items() if k != "incident"})
        found[b] = {}
        for name in sorted(libs, key=lambda k: k == "build"):  # the build's outputs last
            assert getattr(libs[name][0], launcher)(*args) == 0, f"{what} {name}: launch failed"
            torch.cuda.synchronize()
            found[b][name] = _digests(outputs)
        if scene.num_lamps and cfg.light_samples:
            t_sh = kd.shadow_pass(scene, cfg, out, ctx, draws) if scene.de_shapes else None
            kd.launch_nee_kernel(scene, cfg, wl, out, ctx, draws, bank, t_sh)
        with kernel_march():
            plain, ref = tracer.bounce_core(scene, cfg, wl, state, draws, record=True)
        vec_err, b_err, share = _compare(plain, out, what)
        assert share == 0.0, f"{what}: {share:.4%} divergent lanes"
        keys = ("is_diffuse", "dispersed", "recorded", "miss") + (("reflected",) if chain else ())
        _flags_equal(ref, info, keys, what)
        refl = ref["reflected"]
        vectors = ("position", "normal", "brdf_stored")
        if chain:
            _flags_equal(ref, info, ("color_prog",), what, refl)
            vectors += ("color_prob", "path_prob")
        worst = max(worst, vec_err, b_err, _close_where(ref, info, vectors, refl, what))
    print(f"[record] {label} ({os.path.basename(path)}): {wl.shape[0]} lanes, S={wl.shape[1]}, "
          f"bounces 0 and 1 against the plain version: max abs err {worst:.3g}, flags exact")
    return found, worst


def _colors_cost(scene, colors):
    """(bytes, FP32 operations) of one program_colors_kernel launch on the
    lamp vertices ``colors`` (vertex_colors' arguments but the scene's and
    the wavelengths): per vertex its program and flag in (5) and S colors
    out; a valid vertex whose program runs code also reads its normal,
    incident direction and uv (32) and its program's leaves at S columns,
    one whose program reads no ray its row of the launch's values (4 S);
    the program tables once. Operations: a program value a column of each
    valid vertex."""
    import torch

    programs, prog = scene.dense_pack["programs"], colors[0].long()
    s_count = colors[5].shape[1]
    n_color = len(scene.color_programs)
    in_range = colors[1].bool() & (prog >= 0) & (prog < n_color)
    code = torch.tensor([bool(programs.program_code(programs.index("color", c)))
                         for c in range(n_color)] + [False], device=prog.device)
    runs_code = in_range & code[torch.where(in_range, prog, n_color)]
    leaf = _leaf_bytes(scene, "color", torch.where(runs_code, prog, -1))
    size = _program_bytes(scene) + prog.numel() * (5 + 4 * s_count) + (
        int(runs_code.sum()) * 32 + s_count * int(leaf.sum())
        + int((in_range & ~runs_code).sum()) * 4 * s_count)
    return size, int(colors[1].sum()) * OPS["program"] * s_count


def _libs_line(what, times, bound, digests, order):
    """One summary line of _time_libs' result: each library's mean ms (the
    build's and a parent's over their two runs), the bound and whether the
    build's outputs are bit-equal to the parent's and to a_parent_form's."""
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    same = []
    for other in ("parent", "a_parent_form"):
        if other in digests:
            bad = [k for k, v in digests["build"].items() if digests[other].get(k) != v]
            same.append(f"against {other}: " + ("every output bit-equal" if not bad
                                                 else f"differ: {', '.join(bad)}"))
    print(f"[record-rows] {what}: " + "; ".join(f"{k} {ms[k]:.4f}" for k in dict.fromkeys(order))
          + f" ms; bound {bound[0]:.4f} ms ({bound[1]}); " + "; ".join(same))
    return ms


def measure_record_rows(card, tmp, parent_csrc=None, save=None):
    """``--rows``' kernels A and D (``--record-rows`` alone): each form of
    RECORD_FORMS at camera bounces 0 and 1 (record_inputs) and D on
    textures_bdpt's lamp vertices (check_bdpt) and on color_edge_batches
    (check_color_edges: held to the plain version), through the build, the
    probes of RECORD_VARIANTS and, given PARENT_CSRC (a parent checkout's
    csrc/), the parent's kernels, on the same inputs in the order parent,
    build, probes, build, parent: ms per launch, the bound of the inputs,
    and whether each output is bit-equal to the parent kernel's (digests);
    first each library's registers, shared memory and resident warps
    (print_record_registers). Writes the times, bounds and digests to
    ``save``. Returns {case: {library: ms}}."""
    from pyrite_tpu_torch import _build, kernels_dense as kd

    started = time.perf_counter()
    libs = {"build": (_build.load(), _build.build_log)}
    variants = dict(RECORD_VARIANTS, **({"parent": parent_csrc} if parent_csrc else {}))
    libs.update(build_variants(os.path.join(tmp, "record_variants"), variants, tag="record-rows"))
    print(f"[record-rows] builds {sorted(libs)} ready in {time.perf_counter() - started:.1f} s")
    found = {"ms": {}, "runs": {}, "bound": {}, "digests": {}, "regs": {}}
    for name, (lib, log) in libs.items():
        found["regs"][name] = print_record_registers(lib, log, name)
    if "parent" in libs:  # every instantiation whose registers or spills the build changed
        mine, theirs = kernel_registers(libs["build"][1]), kernel_registers(libs["parent"][1])
        found["regs"]["parent -> build"] = {k: (theirs.get(k), mine.get(k)) for k in sorted(
            set(mine) | set(theirs)) if mine.get(k) != theirs.get(k)}
        print("[record-regs] parent -> build, registers, spill stores / loads: " + "; ".join(
            f"{k} {a} -> {b}" for k, (a, b) in found["regs"]["parent -> build"].items()))
    ends = ["parent"] if "parent" in libs else []
    order = ends + ["build"] + [k for k in RECORD_VARIANTS if k in libs] + ["build"] + ends
    paths = record_scene_paths(os.path.join(tmp, "record"))

    def record(what, launcher, args, outputs, cost):
        digests, times = _time_libs(what, launcher, args, outputs, libs, order, card)
        bound = _bound_ms(*cost)
        found["ms"][what] = _libs_line(what, times, bound, digests, order)
        found["runs"][what] = times
        found["bound"][what] = bound
        found["digests"][what] = digests

    for label, key, chain in RECORD_FORMS:
        scene, cfg, wl, bank, bounces = record_inputs(paths[key], chain)
        launcher = kd._LAUNCHERS[kd.record_name(scene)]
        for b, (state, draws, t_de) in enumerate(bounces):
            args, out, ctx, info = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank, t_de,
                                                         True, chain)
            outputs = dict(out, **ctx, **{k: v for k, v in info.items() if k != "incident"})
            what = (f"{label} bounce {b} ({wl.shape[0]} lanes, S={wl.shape[1]}, alive share "
                    f"{float(state['alive'].float().mean()):.4f})")
            record(what, launcher, args, outputs, _record_cost(scene, cfg, wl, state, draws, chain))
    checked = check_bdpt("textures_bdpt", paths["textures_bdpt"])
    scene, _, _, wl, bank = checked["setup"]
    colors = checked["timed"]["colors"]
    args, out = kd.vertex_colors_args(scene, *colors, bank)
    record(f"textures_bdpt program_colors_kernel ({int(colors[1].sum())} valid of "
           f"{colors[1].numel()} slots)", "pyrite_program_colors", args, {"colors": out},
           _colors_cost(scene, colors))
    edges, _ = check_color_edges("textures_bdpt", paths["textures_bdpt"], wl, bank)
    for case, (args, out, *_) in edges.items():
        record(f"program_colors_kernel edge {case}", "pyrite_program_colors", args, {"colors": out},
               (0, 0))
    if save:
        with open(save, "w") as fh:
            json.dump(dict(found, card=card, order=order), fh)
    print(f"[phase] A and D alone (--record-rows): {time.perf_counter() - started:.1f} s")
    return found["ms"]


# --- phase 8: multi-device on one card --------------------------------------------

# Its tolerances: a merged film against the one-process film of the same
# render. The simple renderer's weights are ones, so wt must be equal (phase
# 5's rule); the bidirectional and photon weights are not, so wt within
# rtol 1e-6 (check_regen_bdpt's rule); acc within rtol 1e-4 (/ atol 1e-6).
MULTI_RTOL = 1e-4


def multi_device_step(flagship, bdpt_deep, flagship_photon, card, out_dir, devices=None,
                      backend="gloo", spp=(4, 4, 4, 2)):
    """Phase 8: two ranks share cuda:0 over gloo (``devices`` None;
    parallel.spawn with cli.render_ranks, the CLI's sharded path but for its
    device count and backend: NCCL refuses two ranks on one card) and
    render, at phases 5-7's widths, the flagship (512 x 256, S = 6, 8
    bounces) through regeneration and through one-shot, flagship_bdpt_deep
    (16 + 8 bounces) through regen BDPT and flagship_photon, at ``spp``
    samples each (4, 4, 4, 2). Each merged film is held to the one-process
    film of the same render on this process (MULTI_RTOL); every rank must
    have launched each render's kernels (bounce or <record>, NEE, draws;
    lamp and shadow for BDPT; lamp and gather for photon) and no plain
    version. A warm-up render, a sample a rank, comes first in each rank
    and here. Prints the one-process render's wall, each rank's render wall
    and peak memory and the merges' bytes and ms a call. ``--cards`` runs
    the same over ``devices`` (one rank a card) with ``backend`` nccl.
    Returns the ranks' launch counts, one flat dict per rank and render."""
    import torch

    from pyrite_tpu_torch import cli, kernels_dense as kd, parallel
    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import bidirectional as bd, photon as ph, simple

    started = time.perf_counter()
    shared = devices is None
    devices = ["cuda:0", "cuda:0"] if shared else devices
    how = (f"{len(devices)} ranks sharing one card, {backend} through the host over PCIe: not a "
           f"scaling figure" if shared else f"{len(devices)} ranks, one a card, {backend}")
    one_shot = {"PYRITE_TPU_REGEN": "0"}
    renders = [("flagship regen", flagship, spp[0], None, simple),
               ("flagship one-shot", flagship, spp[1], one_shot, simple),
               ("flagship_bdpt_deep regen", bdpt_deep, spp[2], None, bd),
               ("flagship_photon", flagship_photon, spp[3], None, ph)]
    jobs = [dict(argv=[path, "--samples", str(n), "--output",
                       os.path.join(out_dir, f"multi_{i}.png")], env=env)
            for i, (_, path, n, env, _) in enumerate(renders)]
    # first a one-shot render of the flagship, one sample a rank (with
    # fewer, rank_share leaves the first ranks without work): a process's
    # first render also pays its CUDA start (module loads, the allocator's
    # first blocks, the first CUDA all-reduce), which the timed renders
    # must not
    warm = dict(argv=[flagship, "--samples", str(len(devices)), "--output",
                      os.path.join(out_dir, "multi_w.png")], env=one_shot)
    spawned = time.perf_counter()
    ranks = parallel.spawn(cli.render_ranks, devices, backend, args=([warm] + jobs,), timeout=600)
    world_s = time.perf_counter() - spawned
    firsts = ", ".join(f"{rank[0]['seconds']:.4f}" for rank in ranks)
    print(f"[multi] each rank's first render (the flagship one-shot, a sample a rank, with the "
          f"process's CUDA start): {firsts} s ({how}) ({card})")
    ranks = [rank[1:] for rank in ranks]

    def one_process(path, n, env, renderer):
        saved = os.environ.get("PYRITE_TPU_REGEN")
        os.environ.update(env or {})
        try:
            _zero_counts()
            torch.cuda.synchronize()
            began = time.perf_counter()
            _, acc, wt = renderer.render(load_project(path), _gpu_scene(path)[0], seed=0, max_samples=n)
            torch.cuda.synchronize()
            return acc, wt, time.perf_counter() - began
        finally:
            if saved is None:
                os.environ.pop("PYRITE_TPU_REGEN", None)
            else:
                os.environ["PYRITE_TPU_REGEN"] = saved

    one_process(flagship, 1, one_shot, simple)  # this process's warm-up
    runs = []
    for i, (name, path, n, env, renderer) in enumerate(renders):
        scene = _gpu_scene(path)[0]
        acc, wt, wall = one_process(path, n, env, renderer)
        one = _read_counts()
        got = ranks[0][i]
        acc_m, wt_m = got["acc"].to(acc.device), got["wt"].to(wt.device)
        rel = lambda a, b: float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())  # noqa: E731
        bad = int((wt_m != wt).sum())
        print(f"[multi] {name}, {n} spp: merged film against one process: wt differs in {bad} of "
              f"{wt.numel()} bins (max rel {rel(wt_m, wt):.3e}, total {float(wt_m.sum()):.1f} "
              f"against {float(wt.sum()):.1f}), acc max rel {rel(acc_m, acc):.3e}, max abs "
              f"{float((acc_m - acc).abs().max()):.3e}; one process's render wall {wall:.4f} s "
              f"({card})")
        assert float(wt.sum()) > 0 and bool(torch.isfinite(acc_m).all())
        if renderer is simple:
            assert bad == 0, f"{name}: the merged film's wt differs from one process's"
            torch.testing.assert_close(acc_m, acc, rtol=MULTI_RTOL, atol=0.0)
        else:
            torch.testing.assert_close(wt_m, wt, rtol=1e-6, atol=0.0)
            torch.testing.assert_close(acc_m, acc, rtol=MULTI_RTOL, atol=1e-6)
        bounce_k, nee_k = kd.kernel_names(scene)
        record_k = kd._named(scene, "dense_bounce_kernel<record>")
        per_call = []
        for rank in ranks:
            result = rank[i]
            c = _flat_counts(result["counts"])
            for k in ("bounce_core", "lamp_start", "lamp_bounce_step", "intersect_shadow"):
                assert c[k] == 0, (name, result["rank"], k, c)
            assert c["philox_draws_kernel"] > 0 and c[nee_k] > 0, (name, result["rank"], c)
            if renderer is simple:
                assert c[bounce_k] == c[nee_k] == c["bounces"] > 0, (name, result["rank"], c)
                assert (c["regen_launches"] > 0) == (env is None), (name, result["rank"], c)
            else:
                assert c[record_k] > 0 and c[kd._lamp_name(scene)] > 0, (name, result["rank"], c)
            if renderer is bd:
                assert c["regen_bdpt_walks"] > 0 and c["dense_shadow_kernel"] > 0, c
            if renderer is ph:
                assert c["photon_gather_kernel"] == c["gathers"] > 0, (name, result["rank"], c)
            merges = result["counts"]["merges"]
            per_call.append(merges["seconds"] * 1e3 / max(merges["calls"], 1))
            print(f"[multi] {name}, rank {result['rank']}: render wall {result['seconds']:.4f} s, "
                  f"peak memory {result['peak'] / 2**20:.1f} MiB; {merges['calls']} film merges of "
                  f"{merges['bytes'] // max(merges['calls'], 1)} B, {per_call[-1]:.2f} ms a call "
                  f"with the wait for the other ranks; bounce launches "
                  f"{c['bounces'] + c['camera_bounces'] + c['photon_camera_bounces']} (one process "
                  f"{one['bounces'] + one['camera_bounces'] + one['photon_camera_bounces']}) ({card})")
            runs.append(c)
        print(f"[multi] {name}: a merge takes {min(per_call):.2f} ms (the rank that waited least; "
              f"{how}) ({card})")
    print(f"[phase] multi-device (phase 8, {how}): {time.perf_counter() - started:.1f} s, the "
          f"world's spawn to its end {world_s:.1f} s")
    return runs


def multi_card_step(card, out_dir):
    """``--cards``, on a machine with several cards: multi_device_step over
    every card, one rank a card over NCCL, at 64, 64, 16 and 8 spp, then the
    CLI itself (``python -m pyrite_tpu_torch flagship.lua --multi-device``,
    which spawns one rank a card over NCCL) on the flagship at 16 spp: exit
    0 and a PNG of the film's size; then cards_probe."""
    import torch
    from PIL import Image

    count = torch.cuda.device_count()
    if count < 2:
        raise SystemExit(f"chip_smoke --cards: torch counts {count} CUDA device(s), not several")
    flagship = scene_paths(out_dir, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"]
    multi_device_step(flagship, write_flagship_bdpt(out_dir, "flagship_bdpt_deep", 16, 8),
                      photon_scene_paths(os.path.join(out_dir, "photon"))["flagship_photon"],
                      card, out_dir, devices=[f"cuda:{i}" for i in range(count)], backend="nccl",
                      spp=(64, 64, 16, 8))
    png = os.path.join(out_dir, "cli_multi.png")
    started = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "pyrite_tpu_torch", flagship, "--multi-device",
                           "--samples", "16", "--output", png], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    tail = [line for line in done.stdout.splitlines() if line.startswith(("Rendering:", "Output"))]
    print(f"[multi] the CLI with --multi-device over {count} cards: exit {done.returncode} in "
          f"{time.perf_counter() - started:.1f} s; {tail} ({card})")
    assert done.returncode == 0, done.stderr[-4000:]
    with Image.open(png) as img:
        assert img.size == (512, 256), img.size
    cards_probe(flagship, card, out_dir, os.path.join(out_dir, "trace"),
                [f"cuda:{i}" for i in range(count)], "nccl")


def cards_probe(flagship, card, out_dir, trace_dir, devices, backend):
    """``--cards`` and ``--multi``: where a regeneration rank's wall goes.
    The flagship at 64 spp through regeneration in worlds of one rank
    (devices[0]), of two and of all ``devices`` over ``backend``, with
    NCCL_P2P_DISABLE=1 in the ranks too under nccl; then one rank and all
    with a torch.profiler trace a rank written into ``trace_dir``,
    summarised (_print_trace_summary) and deleted. Prints the host's CPUs
    and each world's rank walls, regen iterations and seconds in merges."""
    import torch

    from pyrite_tpu_torch import cli, parallel

    count = len(devices)
    print(f"[cards-probe] host: {os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} in this "
          f"process's affinity, torch {torch.get_num_threads()} threads; ranks on {devices} over "
          f"{backend} ({card})")
    png = os.path.join(out_dir, "probe.png")
    worlds = [("1 rank", devices[:1], {}, [])]
    worlds += [("2 ranks", devices[:2], {}, [])] if count > 2 else []
    worlds += [(f"{count} ranks", devices, {}, [])]
    worlds += ([(f"{count} ranks, NCCL_P2P_DISABLE=1", devices, {"NCCL_P2P_DISABLE": "1"}, [])]
               if backend == "nccl" else [])
    worlds += [("1 rank, profiled", devices[:1], {}, ["--profile", trace_dir]),
               (f"{count} ranks, profiled", devices, {}, ["--profile", trace_dir])]
    for label, world, env, extra in worlds:
        job = dict(argv=[flagship, "--samples", "64", "--output", png, *extra])
        # a sample a rank first, so that every rank has paid its CUDA start
        warm = dict(argv=[flagship, "--samples", str(len(world)), "--output", png],
                    env={"PYRITE_TPU_REGEN": "0"})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)  # the ranks inherit this process's environment
        try:
            ranks = parallel.spawn(cli.render_ranks, world, backend, args=([warm, job],),
                                   timeout=600)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        walls = ", ".join(f"{rank[1]['seconds']:.4f}" for rank in ranks)
        iters = ", ".join(str(rank[1]["counts"]["simple"]["regen_iterations"]) for rank in ranks)
        merges = ", ".join(f"{rank[1]['counts']['merges']['seconds']:.4f}" for rank in ranks)
        print(f"[cards-probe] flagship regen 64 spp, {label}: rank render walls {walls} s; regen "
              f"iterations {iters}; seconds in merges {merges} ({card})")
        if extra:
            for name in sorted(os.listdir(trace_dir)):
                _print_trace_summary(os.path.join(trace_dir, name), label, card)
            shutil.rmtree(trace_dir)


def _print_trace_summary(path, label, card, top=12):
    """A Chrome trace's (torch.profiler's) time by category and its
    longest CUDA runtime calls, kernels and CPU ops by total duration."""
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    span = (max(e["ts"] + e.get("dur", 0) for e in events) - min(e["ts"] for e in events)) / 1e3
    by_cat, by_name = {}, {}
    for e in events:
        cat, dur = e.get("cat", "?"), e.get("dur", 0) / 1e3
        by_cat[cat] = by_cat.get(cat, 0.0) + dur
        key = (cat, e["name"][:48])
        total, calls = by_name.get(key, (0.0, 0))
        by_name[key] = (total + dur, calls + 1)
    cats = ", ".join(f"{c} {v:.1f}" for c, v in sorted(by_cat.items(), key=lambda kv: -kv[1]))
    print(f"[cards-probe] {label}, {os.path.basename(path)}: span {span:.1f} ms; ms by category: "
          f"{cats} ({card})")
    for cat in ("cuda_runtime", "cuda_driver", "kernel", "gpu_memcpy", "user_annotation", "cpu_op"):
        rows = sorted(((k[1], v) for k, v in by_name.items() if k[0] == cat), key=lambda kv: -kv[1][0])
        if rows:
            print(f"[cards-probe]   {cat}: " + "; ".join(
                f"{name} {total:.1f} ms / {calls}" for name, (total, calls) in rows[:top]))


def _gpu_info():
    """(torch's device name, nvidia-smi's "name, power.limit" line, max SM
    clock in MHz)."""
    import torch

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]

    clock = float(smi("clocks.max.sm").split()[0])
    _SM_CLOCK_MHZ.append(clock)
    return torch.cuda.get_device_name(0), smi("name,power.limit"), clock


_SM_CLOCK_MHZ = []  # the max SM clock _gpu_info read


def _fp32_rate():
    """FP32 operations per second: 132 SMs x 128 FP32 lanes x the max SM
    clock."""
    return 132 * 128 * _SM_CLOCK_MHZ[-1] * 1e6


KERNEL_NAMES = ("dense_bounce_kernel", "dense_nee_kernel", "wide_bounce_kernel", "wide_nee_kernel",
                "wide_closest_kernel", "wide_shadow_kernel", "march_de_kernel", "dense_lamp_kernel",
                "wide_lamp_kernel", "dense_shadow_kernel", "program_colors_kernel",
                "photon_gather_kernel", "philox_draws_kernel")


def _kernel_label(mangled):
    """A kernel's name from its mangled one: the bounce, NEE and lamp
    kernels as name<true> / name<false> (kDE), with <record> and <prog>
    after it for their kRecord and kProg instantiations, <gate> for the
    bounce and NEE kernels' kGate ones that are not kProg and <stream> for
    their kStream ones (the gate form past 16 columns, and the kProg
    camera walk's with its whole own rows at S <= 16:
    <record><prog><stream>), <chunks> for the kProg ones past 16 columns
    that make their own rows in chunks (and photon_gather_kernel's past 64
    fresh wavelengths, philox_draws_kernel's past 92 camera words) and
    <out_row> for photon_gather_kernel's bins in its output row; None for a
    function that is none of KERNEL_NAMES."""
    name = next((k for k in KERNEL_NAMES if k in mangled), None)
    if name is None:
        return None
    flags = re.search(r"I((?:Lb[01]E)+)E", mangled)
    if flags and name in ("photon_gather_kernel", "philox_draws_kernel"):  # kChunks, kOutRow
        bits = re.findall(r"Lb([01])E", flags.group(1))
        return name + ("<chunks>" if bits[0] == "1" else "") + (
            "<out_row>" if bits[1:2] == ["1"] else "")
    if flags:  # <kDE>, the bounce kernels' kRecord, then kProg, kGate, kStream and kWhole
        bits = re.findall(r"Lb([01])E", flags.group(1))
        name += "<true>" if bits[0] == "1" else "<false>"
        record, rest = (bits[1:2], bits[2:]) if "bounce" in name else ([], bits[1:])
        stream, prog = rest[2:3] == ["1"], rest[:1] == ["1"]
        # a bounce kernel's kWhole (absent before it was added: whole rows)
        chunks = stream and prog and ("bounce" not in name or rest[3:4] == ["0"])
        tag = ("<prog>" if prog else "<gate>" if rest[1:2] == ["1"] and not stream
               else "") + ("<chunks>" if chunks else "<stream>" if stream else "")
        name += ("<record>" if record == ["1"] else "") + tag
    tags = {"QueryShadowRays": "<query shadow>", "QueryRays": "<query>",
            "BounceRays": "<bounce>", "ShadowRays": "<shadow>"}
    return name + next((tag for t, tag in tags.items() if t in mangled), "")


def kernel_registers(log):
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ptxas -v report in a build log (_build.build_log), named by
    _kernel_label."""
    found = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = _kernel_label(chunk.split("'")[1])
        used = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if name is None or used is None:
            continue
        stores, loads = (int(x) for x in spill.groups()) if spill else (0, 0)
        found[name] = (int(used.group(1)), stores, loads)
    return found


def _print_registers(log):
    print(f"[build] kernels, registers and spill stores / loads (ptxas -v): " + "; ".join(
        f"{k} {r}, {st}/{ld} B" for k, (r, st, ld) in sorted(kernel_registers(log).items())))


def profile_renders(card, runs=5, flagship_only=False):
    """``--profile``: the main-path renders through renderers.simple.render
    (flagship and terrain_405 at 64 spp, fractal.lua at 8 spp; with
    ``flagship_only``, ``--walls``, flagship alone), each through
    the one-shot wavefront and through regeneration (profile_render)."""
    with tempfile.TemporaryDirectory() as tmp:
        scenes = [
            (scene_paths(tmp, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"], 64),
            (terrain_paths(tmp, cells=(405,), spp=64)["terrain_405"], 64),
            (os.path.join(ROOT, "examples", "fractal.lua"), 8),
        ]
        for path, spp in scenes[:1] if flagship_only else scenes:
            for which in ("one-shot", "regen"):
                profile_render(path, spp, card, which, runs)


def profile_render(path, spp, card, which, runs=5):
    """One render of ``spp`` samples through renderers.simple.render under
    the scheduler ``which``: ``runs`` timed runs after a warm-up, then one
    under torch.profiler. Prints the launches and lane-bounces of one
    render, its peak memory, the wall times, the device's busy time (the
    sum of its kernels' own times) and idle share (1 - busy / wall of the
    profiled run; the profiler slows the host, so the unprofiled share is
    lower) and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import simple

    scene = _gpu_scene(path)[0]
    project_data = load_project(path)

    def render():
        torch.cuda.synchronize()
        started = time.perf_counter()
        simple.render(project_data, scene, max_samples=spp)
        torch.cuda.synchronize()
        return time.perf_counter() - started

    with scheduler(which):
        render()
        _zero_counts()
        torch.cuda.reset_peak_memory_stats()
        walls = [render()]
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated()
        walls += [render() for _ in range(runs - 1)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = render()
    # the kernels themselves: a CPU op's device time repeats its kernels'
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    own = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total  # noqa: E731
    busy = sum(own(e) for e in events) / 1e3
    top = sorted(events, key=own, reverse=True)[:8]
    r = project_data.project.renderer
    im = project_data.project.image
    rays = im.width * im.height * spp * r.bounces * (1 + r.light_samples)
    median = sorted(walls)[len(walls) // 2]
    print(f"[profile] {os.path.basename(path)} {im.width}x{im.height}, {spp} spp, {which} "
          f"({card}): launches {launches}; {_lanes_line(launches)}; peak memory "
          f"{peak / 2**20:.1f} MiB; render wall s {', '.join(f'{w:.4f}' for w in walls)}; "
          f"median {median:.4f} s, {rays / median / 1e6:.3f} Mrays/s nominal, "
          f"{launches['live_lane_bounces'] * (1 + r.light_samples) / median / 1e6:.3f} "
          f"Mrays/s live")
    print(f"[profile] profiled run: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / (wall * 1e3):.3f}; top device ops: " + "; ".join(
              f"{e.key[:60]} {own(e) / 1e3:.3f} ms ({e.count}x)" for e in top))
    return walls, busy


def profile_bdpt(card, runs=5, only=None):
    """``--profile``, the bidirectional renders through
    renderers.bidirectional.render: cornell_class at 8 spp, flagship_bdpt
    (fused) and flagship_bdpt_24 (two-phase) at 16 spp,
    terrain_405_bdpt at 16 spp, and flagship_bdpt_deep, flagship_bdpt_64
    and flagship_bdpt_256 at 16 spp through the regen scheduler (their 16,
    64 and 256 camera bounces take it) and through the one-shot step
    (regen_bdpt_from(None)), each ``runs`` timed runs after a warm-up, then
    one under torch.profiler. Prints the launches, the rays they trace
    (camera and lamp lane-bounces, NEE samples, connection and splat rays)
    and Mrays/s, the regen walks' iterations and flushes, peak memory, wall
    times, device busy time and idle share, and the top device ops; then
    regen's median wall over one-shot's at each camera budget (the
    crossover). ``only``: the scene names to profile (all by default)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyrite_tpu_torch.project import load_project
    from pyrite_tpu_torch.renderers import bidirectional as bd

    with tempfile.TemporaryDirectory() as tmp:
        paths = bdpt_scene_paths(tmp, spp=16)
        deep = ("flagship_bdpt_deep", "flagship_bdpt_64", "flagship_bdpt_256")
        medians = {}
        for name, spp, regen in (
                [("cornell_class", 8, True), ("flagship_bdpt", 16, True),
                 ("flagship_bdpt_24", 16, True), ("terrain_405_bdpt", 16, True)]
                + [(name, 16, regen) for name in deep for regen in (True, False)]):
            if only is not None and name not in only:
                continue
            path = paths[name]
            scene = _gpu_scene(path)[0]
            project_data = load_project(path)

            def render():
                torch.cuda.synchronize()
                started = time.perf_counter()
                with regen_bdpt_from(bd.REGEN_BDPT_MIN_BOUNCES if regen else None):
                    bd.render(project_data, scene, max_samples=spp)
                torch.cuda.synchronize()
                return time.perf_counter() - started

            render()
            _zero_counts()
            torch.cuda.reset_peak_memory_stats()
            walls = [render()]
            launches = _read_counts()
            peak = torch.cuda.max_memory_allocated()
            walls += [render() for _ in range(runs - 1)]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = render()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            own = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            busy = sum(own(e) for e in events) / 1e3
            top = sorted(events, key=own, reverse=True)[:10]
            r = project_data.project.renderer
            rays = (launches["live_lane_bounces"] * (1 + r.light_samples) + launches["lamp_live"]
                    + launches["connection_rays"] + launches["splat_rays"])
            median = sorted(walls)[len(walls) // 2]
            assert (launches["regen_bdpt_walks"] > 0) == (regen and r.bounces >= bd.REGEN_BDPT_MIN_BOUNCES), launches
            if not launches["regen_bdpt_walks"]:
                assert launches["steps"] == spp, launches  # one chunk a sample
            medians[name, regen] = median
            print(f"[profile-bdpt] {name} {spp} spp, {r.bounces} + {r.light_bounces} bounces, "
                  f"S={r.spectrum_samples}, {_bdpt_schedule(launches, r)} ({card}): launches "
                  f"{launches}; {_lanes_line(launches)}; rays {rays} (camera "
                  f"lane-bounces live {launches['live_lane_bounces']} x (1 + {r.light_samples}), "
                  f"lamp {launches['lamp_live']}, connections {launches['connection_rays']}, "
                  f"splats {launches['splat_rays']}); peak memory {peak / 2**20:.1f} MiB; render "
                  f"wall s {', '.join(f'{w:.4f}' for w in walls)}; median {median:.4f} s, "
                  f"{rays / median / 1e6:.3f} Mrays/s")
            print(f"[profile-bdpt] profiled run: wall {wall * 1e3:.2f} ms, device busy {busy:.2f} "
                  f"ms, idle share {1 - busy / (wall * 1e3):.3f}; top device ops: " + "; ".join(
                      f"{e.key[:60]} {own(e) / 1e3:.3f} ms ({e.count}x)" for e in top))
        for name in deep:
            if (name, True) in medians:
                regen, one_shot = medians[name, True], medians[name, False]
                print(f"[profile-bdpt] crossover: {name} regen {regen:.4f} s against one-shot "
                      f"{one_shot:.4f} s median wall, regen / one-shot {regen / one_shot:.3f} ({card})")


# Variants of csrc/bounce.cu for --prog (measure_prog), each removing or
# moving one cost of the kProg instantiations' program evaluation. A
# variant is a list of alternative edits, the first whose anchors are all in
# the source applying (this tree's two-part interpreter, eval_program, or a
# checkout's from before it, eval_code); an edit is (anchor, the text that
# replaces it), anchor None appending the text. "no_taps": every texture
# sample a constant, no tap read (what all the texture work costs);
# "stack_moved": the interpreter's stack from shared to local memory, or
# from local to shared; "scalar_taps": a colour tap as four scalar loads,
# not one float4; "min_blocks_<b>": every kernel's __launch_bounds__ asking
# for b resident blocks of 128 threads (a register cap of 65,536 / 128 b;
# dense_nee_kernel<prog> keeps its own); "nee_uncapped": that kernel
# without its request for 6 blocks;
# "row_loop": a texture sample's four rows of taps one after another in a
# loop the compiler does not unroll (4 loads in flight, not 16);
# "inline_flipped": this tree's inlined interpreter made a called function,
# or a checkout's called one inlined at each call; "no_sphere_frames":
# a sphere hit's or lamp sample's frame and uv without their libm calls
# (acos, atan2, sin, cos: what they cost); "counted": the
# active lanes of every warp-instruction of the interpreter's loop summed
# (__activemask), for its SIMT efficiency.
_SHARED_STACK = """struct SharedStack {
  float4* at;
  __device__ __forceinline__ float4& operator[](int i) const { return at[i * BLOCK]; }
};

"""
_COUNT_SRC = """
// prog_lanes: the active lanes summed over the interpreter's
// warp-instructions, and those warp-instructions
__device__ unsigned long long prog_lanes[2];
__device__ __forceinline__ void prog_count() {
  const unsigned m = __activemask();
  if ((threadIdx.x & 31) == __ffs(m) - 1) {
    atomicAdd(&prog_lanes[0], (unsigned long long)__popc(m));
    atomicAdd(&prog_lanes[1], 1ull);
  }
}
"""
_COUNT_READ = """
extern "C" int prog_lanes_read(unsigned long long* out) {
  const unsigned long long zero[2] = {0, 0};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, prog_lanes, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(prog_lanes, zero, sizeof(zero));
  return (int)e;
}
"""
_TAP_ROWS = """  float4 rows[4];
  for (int r = 0; r < 4; ++r) {
    float4 taps[4];
    for (int c = 0; c < 4; ++c) {
      const float* p = pa.tex + off + ((size_t)ys[r] * width + xs[c]) * channels;
      taps[c] = channels == 1 ? f4(__ldg(p)) : __ldg(reinterpret_cast<const float4*>(p));
    }
    rows[r] = cubic(taps[0], taps[1], taps[2], taps[3], tx);
  }
  return cubic(rows[0], rows[1], rows[2], rows[3], ty);
"""
_TAP_ROW_LOOP = """  float4 r0, r1, r2, r3;
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    const int y = r == 0 ? ys[0] : r == 1 ? ys[1] : r == 2 ? ys[2] : ys[3];
    float4 taps[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* p = pa.tex + off + ((size_t)y * width + xs[c]) * channels;
      taps[c] = channels == 1 ? f4(__ldg(p)) : __ldg(reinterpret_cast<const float4*>(p));
    }
    const float4 row = cubic(taps[0], taps[1], taps[2], taps[3], tx);
    if (r == 0) r0 = row; else if (r == 1) r1 = row; else if (r == 2) r2 = row; else r3 = row;
  }
  return cubic(r0, r1, r2, r3, ty);
"""
_SPHERE_FRAME = "__device__ void sphere_frame(V3 n, float su, float sv, float4& q, float& u, float& v) {\n"
_TEXTURE_FN = "__device__ float4 sample_texture(const ProgArgs& pa, int t, float u, float v) {\n"
_FETCH = "const int op = pr.code_op[i], arg = pa.arg[i];"
PROG_VARIANTS = {
    "no_taps": [[(_TEXTURE_FN, _TEXTURE_FN + "  return f4(0.5f);\n")]],
    "stack_moved": [
        [("return at[i * BLOCK];", "return at[i];"),
         ("  extern __shared__ __align__(16) float4 prog_smem[];\n"
          "  const ProgStack st = {prog_smem + threadIdx.x};\n",
          "  float4 stack[PROG_STACK];\n  const ProgStack st = {stack};\n")],
        [("return at[i * BLOCK];", "return at[i];"),
         ("  __shared__ float4 stack[PROG_STACK * BLOCK];\n  const ProgStack st = {stack + threadIdx.x};\n",
          "  float4 stack[PROG_STACK];\n  const ProgStack st = {stack};\n")],
        [("  float4 st[PROG_STACK];\n  int sp = 0;\n",
          "  __shared__ float4 st_shared[PROG_STACK * BLOCK];\n"
          "  const SharedStack st = {st_shared + threadIdx.x};\n  int sp = 0;\n"),
         ("__device__ __noinline__ float4 eval_code(",
          _SHARED_STACK + "__device__ __noinline__ float4 eval_code(")]],
    "scalar_taps": [[("__ldg(reinterpret_cast<const float4*>(p))",
                      "make_float4(p[0], p[1], p[2], p[3])")]],
    **{f"min_blocks_{b}": [[("__launch_bounds__(BLOCK)", f"__launch_bounds__(BLOCK, {b})")]]
       for b in (5, 6)},
    "nee_uncapped": [[("__launch_bounds__(BLOCK, 6)", "__launch_bounds__(BLOCK)")]],
    "row_loop": [[(_TAP_ROWS, _TAP_ROW_LOOP)]],
    "inline_flipped": [
        [("__device__ __forceinline__ float4 eval_program(",
          "__device__ __noinline__ float4 eval_program(")],
        [("__device__ __noinline__ float4 eval_code(", "__device__ __forceinline__ float4 eval_code(")]],
    "no_sphere_frames": [[(_SPHERE_FRAME, _SPHERE_FRAME + "  q = make_float4(1.0f, 0.0f, 0.0f, 0.0f);\n"
                                          "  u = n.x;\n  v = n.y;\n  return;\n")]],
    "counted": [[(_FETCH, _FETCH + " prog_count();"),
                 ('#include "wide_bvh.cuh"\n', '#include "wide_bvh.cuh"\n' + _COUNT_SRC),
                 (None, _COUNT_READ)]],
}


def build_variants(tmp, variants=None, tag="prog"):
    """``variants`` (PROG_VARIANTS by default) built from edited copies of
    csrc/ under ``tmp`` (or, where a variant names a directory, from a copy
    of that csrc/ as it is), with the library's flags (one nvcc per .cu of
    every variant, all at once, then a link each). Returns {name: (loaded
    library, build log)}; a variant none of whose edits applies to this
    checkout is skipped."""
    import ctypes
    import glob

    from pyrite_tpu_torch import _build

    nvcc = _build.find_nvcc()
    sources = {}

    def source(unit):
        if unit not in sources:
            with open(os.path.join(_build.CSRC, unit)) as fh:
                sources[unit] = fh.read()
        return sources[unit]

    jobs = []
    for name, alternatives in (PROG_VARIANTS if variants is None else variants).items():
        root = os.path.join(tmp, name)
        if isinstance(alternatives, str):  # another checkout's csrc/ as it is
            shutil.copytree(alternatives, os.path.join(root, "csrc"))
        else:
            # an edit is (anchor, text) of bounce.cu or (anchor, text, file)
            edits = next((e for e in alternatives if all(
                a is None or a in source(f[0] if f else "bounce.cu") for a, _, *f in e)), None)
            if edits is None:
                print(f"[{tag}] variant {name}: no edit applies to this checkout")
                continue
            edited = {}
            for anchor, text, *unit in edits:
                unit = unit[0] if unit else "bounce.cu"
                src = edited.get(unit, source(unit))
                edited[unit] = src + text if anchor is None else src.replace(anchor, text)
            shutil.copytree(_build.CSRC, os.path.join(root, "csrc"))
            for unit, src in edited.items():
                with open(os.path.join(root, "csrc", unit), "w") as fh:
                    fh.write(src)
        units = sorted(glob.glob(os.path.join(root, "csrc", "*.cu")))
        objs = [u + ".o" for u in units]
        procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, u], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for u, o in zip(units, objs)]
        jobs.append((name, root, objs, procs))
    libs = {}
    for name, root, objs, procs in jobs:
        log = "\n".join(p.communicate(timeout=600)[0] for p in procs)
        assert all(p.returncode == 0 for p in procs), f"variant {name}: nvcc failed\n{log}"
        so = os.path.join(root, "lib.so")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, *objs], check=True,
                       capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):  # another checkout's library may lack one
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def time_prog_kernels(path, lib, card, what, seed=1):
    """The scene's bounce and NEE kernels through ``lib`` at bounce 0 of
    the main path's wavefront: ms per launch (two windows of 50 after a
    warm-up) or, with a "counted" variant's library, one launch each and
    the interpreter's SIMT efficiency (active lanes over 32 per
    warp-instruction). Returns {name: ms or (lanes, warp-instructions)}."""
    import ctypes

    import torch

    from pyrite_tpu_torch import kernels_dense as kd

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, 0)
    bank = kd.precompute_bank_values(scene, wl)
    bounce_name, nee_name = kd.kernel_names(scene)
    b_args, out, ctx = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank)
    runs = {bounce_name: lambda: getattr(lib, kd._LAUNCHERS[bounce_name])(*b_args)}
    assert runs[bounce_name]() == 0, f"{bounce_name}: launch failed"
    n_args = kd.nee_kernel_args(scene, cfg, wl, out, ctx, draws, bank)
    runs[nee_name] = lambda: getattr(lib, kd._LAUNCHERS[nee_name])(*n_args)
    counted = hasattr(lib, "prog_lanes_read")
    found = {}
    for name, run in runs.items():
        if counted:
            counts = (ctypes.c_ulonglong * 2)()
            assert lib.prog_lanes_read(ctypes.byref(counts)) == 0
            assert run() == 0
            assert lib.prog_lanes_read(ctypes.byref(counts)) == 0
            found[name] = (counts[0], counts[1])
            print(f"[prog] {what} {os.path.basename(path)} {name}: interpreter warp-instructions "
                  f"{counts[1]}, active lanes {counts[0]}, SIMT efficiency "
                  f"{counts[0] / max(32 * counts[1], 1):.4f} ({card})")
            continue
        for _ in range(2):
            assert run() == 0, f"{name}: launch failed"
        torch.cuda.synchronize()
        k1, k2 = _event_ms(run, 50), _event_ms(run, 50)
        found[name] = (k1 + k2) / 2
        print(f"[prog] {what} {os.path.basename(path)} {name}: {k1:.4f} / {k2:.4f} ms per launch at "
              f"bounce 0, {wl.shape[0]} lanes ({card})")
    return found


def print_local_memory():
    """LDL / STL (local-memory loads and stores) in the library's SASS
    (cuobjdump -sass): in its program interpreter (a function named
    eval_code or eval_program, where the compiler keeps it apart) and in
    each kProg kernel, whose count includes the interpreter's where it is
    compiled into the kernel."""
    from pyrite_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path()], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            counts.setdefault(name, [0, 0])
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and op and op.group(1)[:3] in ("LDL", "STL"):
            counts[name][op.group(1)[:3] == "STL"] += 1
    interp = {k: v for k, v in counts.items() if "eval_code" in k or "eval_program" in k}
    kernels = {_kernel_label(k): v for k, v in counts.items()
               if (_kernel_label(k) or "").endswith("<prog>")}
    print("[prog] LDL / STL in the SASS: interpreter " + (
        "; ".join(f"{k[:60]} {v[0]} / {v[1]}" for k, v in interp.items()) or "none apart") +
          "; kProg kernels " + "; ".join(f"{k} {v[0]} / {v[1]}" for k, v in sorted(kernels.items())))


def measure_prog(card):
    """``--prog``: the kProg instantiations alone. Their registers and
    spills (after the build), occupancy, local-memory instructions and, on
    the textures scenes of texture_paths at bounce 0, the bounce and NEE
    kernels' times with their bounds and taps per lane (time_kernels) beside
    the untextured instantiations; A, B and program_colors_kernel on
    textures_bdpt (time_bdpt); then each PROG_VARIANTS build on textures
    and textures_1k (times, registers; the counted variant's SIMT
    efficiency). Copied into a parent's checkout, it measures the parent
    the same way."""
    print_occupancy(6)
    print_local_memory()
    with tempfile.TemporaryDirectory() as tmp:
        tex = texture_paths(os.path.join(tmp, "textures"))
        started = time.perf_counter()
        variants = build_variants(tmp)
        print(f"[prog] variants {sorted(variants)} built in {time.perf_counter() - started:.1f} s")
        for name in ("textures", "textures_512", "textures_1k", "untextured"):
            time_kernels(tex[name], card, plain_reps=1)
        checked = check_bdpt("textures_bdpt", tex["textures_bdpt"])
        time_bdpt(checked, card)
        for variant, (lib, log) in variants.items():
            print(f"[prog] variant {variant}: registers and spill stores / loads " + "; ".join(
                f"{k} {r}, {st}/{ld} B" for k, (r, st, ld) in sorted(kernel_registers(log).items())
                if k.endswith("<prog>")))
            for name in ("textures", "textures_1k"):
                time_prog_kernels(tex[name], lib, card, f"variant {variant}")
            if not hasattr(lib, "prog_lanes_read"):
                time_bdpt(checked, card, (variant, lib))


# --bdpt-probes' variants of csrc/bounce.cu, B and C with a part cut or
# changed, for this tree and (the first alternative that applies) the
# parent's. "c_no_sweep": C without its primitive sweep (the rays still
# read); "b_no_hit": B without its closest-hit sweep and DE hits (every
# lane misses: no surface or scatter either); "b_no_shade": B with the hit
# but no surface, pick or scatter; "b_no_de_normals": B without its DE hits'
# normal probes; "sheet_sweeps": C's sweep reading the sheet (DenseGeo)
# rather than rows staged in shared memory; "lamp_staged": B's dense sweep
# over rows staged in shared memory behind a barrier (_CLOSEST_STAGED);
# "shadow_tiles_<t>": a warp of C taking t tiles of 32 rays; "lamp_bounds":
# the simple dense_lamp_kernel instantiations without their request for 8
# resident blocks of 128 threads (a parent's with it); "shadow_bounds_16":
# C asking for 16.
_C_SWEEP_PARENT = ("  float t = DenseGeo{}.shadow(a.sheet, load3(a.origin, ray), load3(a.direction, ray), t0,\n"
                   "                              a.block_below[ray], true);\n")
_C_SWEEP = "  float best = shadow_staged(sh, prims, o, d, plane_shadow(sh, o, d, a.max_dist[ray]));\n"
_B_SWEEP = "  } else if (alive) {\n    h = geo.closest(sh, o, d, true);\n  }\n"
_B_HIT_PARENT = _B_SWEEP + "  if (kDE && alive) apply_de_closest(sh, a.t_de, a.n, lane, h);\n"
_B_HIT = (_B_SWEEP + "  if (kDE && alive)  // apply_de_closest, its first t read above\n"
          "    for (int j = 0; j < n_de; ++j) {\n"
          "      const float tj = j == 0 ? de0 : a.t_de[(size_t)j * a.n + lane];\n"
          "      if (tj > DIST_EPSILON && tj < h.t) h = {tj, KIND_DE, j, h.u, h.v};\n    }\n")
_B_SHADE = "  if (found) {\n    hit_surface<Geo, kDE>(sh, geo, h, pos, normal, mat);\n    if (kProg) {\n      float4 q;"
_B_NORMALS = ("  if (kDE) de_normals_shared(sh, lamp_smem + (kProg ? pa.own_off : 0) + (threadIdx.x >> 5) "
              "* DE_SLOT_FLOATS,\n                             found && h.kind == KIND_DE, h, o, d, "
              "normal, mat);\n")
_B_LANE = "// One lamp bounce per lane (tracer.lamp_bounce_step): the closest hit\n"
_B_SMEM_IN = "  extern __shared__ __align__(16) float lamp_smem[];\n  const Sheet sh = a.sheet;\n"
_B_OWN = "lamp_smem + (kProg ? pa.own_off : 0)"
_B_SMEM = "  return de ? sizeof(float) * (BLOCK / 32) * DE_SLOT_FLOATS : 0;"
_CLOSEST_STAGED = """// DenseGeo's primitive sweeps over the staged rows, after the planes: the
// same tests on the same floats in the same (sheet) order, so every bit is
// DenseGeo::closest's or ::shadow's.
__device__ __forceinline__ void closest_staged(const Sheet& sh, const float4* prims, V3 o, V3 d,
                                               Hit& h) {
  const int n_prims = sh.count(M_N_PRIMS);
  for (int j = 0; j < n_prims; ++j) {
    const float4 p0 = prims[3 * j], p1 = prims[3 * j + 1], p2 = prims[3 * j + 2];
    const V3 c = {p0.x, p0.y, p0.z};
    float t, u, v;
    if (p0.w == PRIM_TRIANGLE) {
      if (ray_triangle(o, d, c, V3{p1.x, p1.y, p1.z}, V3{p2.x, p2.y, p2.z}, t, u, v) && t < h.t)
        h = {t, KIND_TRIANGLE, j, u, v};
    } else if (p0.w == PRIM_SPHERE) {
      if (ray_sphere(o, d, c, p1.w, t) && t < h.t) h = {t, KIND_SPHERE, j, h.u, h.v};
    }
  }
}

"""
BDPT_VARIANTS = {
    "c_no_sweep": [
        [(_C_SWEEP, "  float best = a.max_dist[ray] + 0.0f * (o.x + o.y + o.z + d.x + d.y + d.z);\n")],
        [(_C_SWEEP_PARENT, "  const V3 o = load3(a.origin, ray), d = load3(a.direction, ray);\n"
                           "  float t = t0 + 0.0f * (o.x + o.y + o.z + d.x + d.y + d.z);\n")]],
    "b_no_hit": [[(_B_HIT, "  }\n")], [(_B_HIT_PARENT, "  }\n")]],
    "b_no_shade": [[(_B_SHADE, _B_SHADE.replace("if (found)", "if (false)"))]],
    "b_no_de_normals": [[(_B_NORMALS, "")]],
    "sheet_sweeps": [[(_C_SWEEP, "  float best = DenseGeo{}.shadow(sh, o, d, a.max_dist[ray], 0.0f, true);\n")]],
    "lamp_staged": [[
        (_B_LANE, _CLOSEST_STAGED + _B_LANE),
        (_B_HIT, "  } else if (alive) {\n    plane_hit(sh, o, d, h);\n"
                 f"    closest_staged(sh, reinterpret_cast<const float4*>({_B_OWN}), o, d, h);\n  }}\n"
                 + _B_HIT[len(_B_SWEEP):]),
        (_B_SMEM_IN, _B_SMEM_IN + f"  stage_prims(sh, reinterpret_cast<float4*>({_B_OWN}));\n  __syncthreads();\n"),
        (_B_OWN + " + (threadIdx.x >> 5)", _B_OWN + " + PRIM_FLOATS + (threadIdx.x >> 5)"),
        (_B_SMEM, "  return sizeof(float) * PRIM_FLOATS + (de ? sizeof(float) * (BLOCK / 32) * DE_SLOT_FLOATS : 0);")]],
    **{f"shadow_tiles_{t}": [[("constexpr int SHADOW_TILES = 8;", f"constexpr int SHADOW_TILES = {t};")]]
       for t in (4, 16)},
    "lamp_bounds": [[("__launch_bounds__(BLOCK, 8) dense_lamp_kernel<", "__launch_bounds__(BLOCK) dense_lamp_kernel<")],
                    [("__launch_bounds__(BLOCK) dense_lamp_kernel", "__launch_bounds__(BLOCK, 8) dense_lamp_kernel")]],
    "shadow_bounds_16": [[("__launch_bounds__(BLOCK) dense_shadow_kernel",
                           "__launch_bounds__(BLOCK, 16) dense_shadow_kernel")]],
}


def kernel_static_smem(log):
    """{kernel: static shared memory bytes} from the ptxas -v report in a
    build log, named by _kernel_label."""
    found = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = _kernel_label(chunk.split("'")[1])
        smem = re.search(r"(\d+) bytes smem", chunk)
        if name is not None:
            found[name] = int(smem.group(1)) if smem else 0
    return found


def resident_warps(registers, smem, threads=128):
    """Warps of blocks of ``threads`` resident on one H100 SM at
    ``registers`` a thread (allocated 256 a warp) and ``smem`` bytes of
    shared memory a block (1 KiB more reserved a block, of 228 KiB), at
    most 32 blocks and 64 warps."""
    warps = threads // 32
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min((65536 // per_warp) // warps, 233472 // (smem + 1024), 32, 64 // warps)
    return blocks * warps


def print_bdpt_registers(log, what="build"):
    """B's and C's registers, spill stores / loads, shared memory and
    resident warps a SM (resident_warps) from the ptxas -v report: the
    static shared memory, and the lamp kernels' <true> instantiations also
    their DE probe slots (dynamic; a kProg launch adds its program stack)."""
    from pyrite_tpu_torch import kernels_dense as kd

    regs, static = kernel_registers(log), kernel_static_smem(log)
    parts = []
    for name in sorted(regs):
        if "lamp_kernel" not in name and "dense_shadow_kernel" not in name:
            continue
        r, st, ld = regs[name]
        smem = static[name] + (kd._DE_SLOT_BYTES if "lamp_kernel<true>" in name else 0)
        parts.append(f"{name} {r} registers, {st}/{ld} B spilled, {smem} B shared, "
                     f"{resident_warps(r, smem)} resident warps")
    print(f"[bdpt-regs] {what}: " + "; ".join(parts))


def time_bdpt_parts(name, checked, card, lib=None, what="build"):
    """``--bdpt``'s times of B and C on check_bdpt's chunk of a scene: the
    lamp kernel in start mode and at lamp depths 0, 1 and 2, and on a dense
    scene dense_shadow_kernel on the connection batch of camera bounce 0
    and on the splat batch, through ``lib`` (the build, or a variant's
    library from build_variants): ms per launch (two windows of 50 after a
    warm-up), the alive or live share, and the bound of the inputs
    (_lamp_cost, _shadow_cost; counted once a scene). Returns {label:
    ms}."""
    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd

    scene, cfg, lamp_cfg, wl, bank = checked["setup"]
    lib = lib or _build.load()
    lamp_name = kd._lamp_name(scene)
    launcher = getattr(lib, kd._LAUNCHERS[lamp_name])
    costs = checked.setdefault("costs", {})
    jobs = {}  # label: (arguments with the tensors they point into, launcher, share, rays, cost)
    start = kd.lamp_kernel_args(scene, wl, checked["timed"]["start"]["words"], bank)
    costs.setdefault("start", lambda: _lamp_cost(scene, lamp_cfg, wl, None, None))
    jobs["start"] = (start, launcher, 1.0, wl.shape[0])
    for d, (state, draws) in enumerate(checked["timed"]["lamps"][:3]):
        t_de = kd.march_pass(scene, lamp_cfg, state) if scene.de_shapes else None
        args = kd.lamp_kernel_args(scene, wl, draws["words"], bank, state, t_de)
        costs.setdefault(f"depth {d}", lambda s=state, dr=draws: _lamp_cost(scene, lamp_cfg, wl, s, dr))
        jobs[f"depth {d}"] = (args + (t_de,), launcher, float(state["alive"].float().mean()),
                              wl.shape[0])
    if not scene.use_clusters:
        for key, label in (("shadow", "connection"), ("splat", "splat")):
            batch = checked["timed"][key]
            t_q = None
            if scene.de_shapes:
                q_args, t_q = kd.query_pass_args(scene, cfg, batch[0], batch[1], batch[2], batch[4])
                assert lib.pyrite_de_march_query_shadow(*q_args) == 0
            args = kd.dense_shadow_args(scene, *batch, t_q)
            costs.setdefault(label, lambda b=batch: _shadow_cost(scene, cfg, b))
            jobs[label] = (args + (t_q,), lib.pyrite_dense_shadow, float(batch[4].float().mean()),
                           batch[0].shape[0])
    times = {}
    for label, (held, fn, share, rays, ) in jobs.items():
        run = lambda: fn(*held[0])  # noqa: E731
        assert run() == 0, f"{name} {label}: launch failed"
        run()
        torch.cuda.synchronize()
        k1, k2 = _event_ms(run, 50), _event_ms(run, 50)
        if callable(costs[label]):
            costs[label] = costs[label]()
        size, ops = costs[label]
        by_bytes, by_ops = size / HBM_BYTES_PER_S * 1e3, ops / _fp32_rate() * 1e3
        kernel = "dense_shadow_kernel" if label in ("connection", "splat") else lamp_name
        times[label] = (k1 + k2) / 2
        print(f"[bdpt-parts] {what} {name} {kernel} {label}: {k1:.4f} / {k2:.4f} ms per launch, "
              f"{rays} rays, {'live' if kernel == 'dense_shadow_kernel' else 'alive'} share "
              f"{share:.4f}; bound {max(by_bytes, by_ops):.4f} ms "
              f"({'bytes' if by_bytes >= by_ops else 'operations'}: {size} bytes, {ops} FP32 "
              f"operations) ({card})")
    return times


def bdpt_step(card, probes=False):
    """``--bdpt``: B and C alone. Their registers, spills and resident
    warps (print_bdpt_registers); check_bdpt (with the shadow edge batches
    and the sparse lamp state) on every scene of bdpt_scene_paths and on
    textures_bdpt; time_bdpt_parts on cornell_class, flagship_bdpt,
    terrain_405_bdpt (B's wide instantiation) and textures_bdpt (B's <prog>
    one); last profile_bdpt of cornell_class and flagship_bdpt (walls,
    device busy time by kernel). ``--bdpt-probes`` (``probes``): check_bdpt
    on cornell_class and flagship_bdpt, then each BDPT_VARIANTS build's
    registers and time_bdpt_parts there. Copied into a parent's checkout,
    either measures the parent the same way (a variant whose anchors are
    not in the checkout is skipped)."""
    from pyrite_tpu_torch import _build

    print_bdpt_registers(_build.build_log)
    with tempfile.TemporaryDirectory() as tmp:
        started = time.perf_counter()
        bdpt = bdpt_scene_paths(tmp, spp=2)
        if probes:
            variants = build_variants(tmp, BDPT_VARIANTS, "bdpt")
            print(f"[bdpt] variants {sorted(variants)} built in {time.perf_counter() - started:.1f} s")
            for name in ("cornell_class", "flagship_bdpt"):
                checked = check_bdpt(name, bdpt[name])
                time_bdpt_parts(name, checked, card)
                for variant, (lib, log) in variants.items():
                    if name == "cornell_class":
                        print_bdpt_registers(log, f"variant {variant}")
                    time_bdpt_parts(name, checked, card, lib, f"variant {variant}")
            return
        bdpt["textures_bdpt"] = texture_paths(os.path.join(tmp, "textures"))["textures_bdpt"]
        checked = {name: check_bdpt(name, path) for name, path in bdpt.items()}
        for name in ("cornell_class", "flagship_bdpt", "terrain_405_bdpt", "textures_bdpt"):
            time_bdpt_parts(name, checked[name], card)
        print(f"[phase] --bdpt checks and times: {time.perf_counter() - started:.1f} s")
    profile_bdpt(card, only=("cornell_class", "flagship_bdpt"))


def measure_rows(flagship, fractal, card):
    """Phase 4 for the dense bounce and NEE kernels (rows 1-2 of PERF.md's
    table): their occupancy at flagship's S and fractal.lua's, the copy
    probes' memory floor and what a warp does (bounce_warp_counts) at
    bounces 0 and 1, and their times on flagship at bounce 0 and on
    fractal.lua at bounces 0 and 1 (with the DE passes'). Returns flagship's
    time_kernels result."""
    for s_count in (6, 8):
        print_occupancy(s_count)
    for bounce in (0, 1):
        time_copy_probes(flagship, card, bounce=bounce)
        bounce_warp_counts(flagship, card, bounce)
        bounce_warp_counts(fractal, card, bounce)
    times = time_kernels(flagship, card)
    for bounce in (0, 1):  # printed: the DE passes' and kernels' times
        time_kernels(fractal, card, plain_reps=1, bounce=bounce)
    return times


def measure_bank(path, card, out_dir):
    """``--rows``, last: materials_300 (``path``) read from its baked colour
    table against the same scene built without_tables (the per-launch
    [Pc, N, S] bank every scene read before the kernels read the table):
    the bounce and NEE kernels' times and bounds (time_kernels) and the
    CLI's peak memory (render_end_to_end), each both ways."""
    for key in (path, bank_key(path)):
        time_kernels(key, card, plain_reps=1)
    for bank in (False, True):
        render_end_to_end(path, 4, card, out_dir, bank=bank)


def check_gate(directory, card, out_dir):
    """Phases 3-5 for the rest of the scene gate (gate_paths): directional
    lamps, more than 16 spectrum samples, tables past 128 rows (the baked
    colour table) and long programs. The draw kernel at S = 32 and 64 bit
    for bit (check_draws); the bounce and NEE kernels against their plain
    version (check_kernels; sunlit_terrain_405 on the first 131,072 lanes,
    the flagship at S = 17, 33 and 110 for two bounces, de_130, de_520 and
    julia_s24 at bounce 0, julia_s24 on one sample of its film), with no
    divergent lane, and the kRecord bounce on flagship_s24_bdpt at bounces
    0 and 1 (wide_rows_case); their times and bounds (time_kernels, printed);
    then the CLI through regeneration (render_end_to_end) on flagship_s32,
    flagship_s64, sunlit_terrain_405, materials_300 and textures_deep.
    Returns (paths, worst errors, draw errors, launch counts of the
    renders)."""
    started = time.perf_counter()
    gate = gate_paths(directory)
    drawn = {name: check_draws(name, gate[name]) for name in ("flagship_s32", "flagship_s64")}
    worst = {name: check_kernels(name, gate[name], **kw) for name, kw in (
        ("sunlit_terrain_405", {"cut": 131072}), ("flagship_s32", {}), ("flagship_s24", {}),
        ("flagship_s64", {}), ("flagship_s17", {"bounces": 2}), ("flagship_s33", {"bounces": 2}),
        ("flagship_s110", {"bounces": 2}), ("terrain_24_s32", {}), ("materials_300", {}),
        ("textures_deep", {}), ("de_130", {"bounces": 1}), ("de_520", {"bounces": 1}),
        ("julia_s24", {"bounces": 1, "lanes": 4096}))}
    divergent = {k: (w["divergent"], w["nee_divergent"]) for k, w in worst.items()
                 if w["divergent"] or w["nee_divergent"]}
    assert not divergent, f"the bounce or NEE kernel diverges from the plain version: {divergent}"
    worst["flagship_s24_bdpt"] = {"record": max(
        wide_rows_case(gate["flagship_s24_bdpt"], b, record=True)[1] for b in (0, 1))}
    for name in ("flagship_s32", "flagship_s64", "sunlit_terrain_405", "materials_300",
                 "textures_deep"):
        time_kernels(gate[name], card, plain_reps=1)  # printed
    runs = [render_end_to_end(gate[name], spp, card, out_dir) for name, spp in (
        ("flagship_s32", 4), ("flagship_s64", 1), ("sunlit_terrain_405", 4), ("materials_300", 4),
        ("textures_deep", 8))]
    print(f"[phase] the rest of the scene gate (phases 3-5): {time.perf_counter() - started:.1f} s")
    return gate, worst, drawn, runs


def check_gate_bdpt(gate, card, out_dir):
    """Phase 6 for the rest of the scene gate: the bidirectional renderer's
    kernels against their plain versions (check_bdpt) on
    sunlit_terrain_405_bdpt (directional lamps start no lamp path) and
    materials_300_bdpt (150 sphere lamps, the baked colour table), and each
    through the CLI (render_bdpt). Returns ({name: check_bdpt's result},
    launch counts of the renders)."""
    started = time.perf_counter()
    checked = {name: check_bdpt(name, gate[name]) for name in (
        "sunlit_terrain_405_bdpt", "materials_300_bdpt")}
    runs = [render_bdpt(gate[name], 2, card, out_dir)[0] for name in checked]
    print(f"[phase] the rest of the scene gate (phase 6): {time.perf_counter() - started:.1f} s")
    return checked, runs


# The flagship's spectral widths --wide-rows measures: the bounce and NEE
# kernels of the gate form past 16 columns (kStream), up to the gate's
# former ceiling (110).
WIDE_ROWS_S = (24, 32, 64, 110)
# The kernels past 16 columns whose registers and occupancy --wide-rows
# prints: the kStream instantiations (a parent's <gate> ones, which ran
# there before them).
WIDE_ROWS_KERNELS = ("dense_bounce_kernel<false><stream>", "dense_bounce_kernel<true><stream>",
                     "dense_bounce_kernel<false><record><stream>",
                     "wide_bounce_kernel<false><stream>", "dense_nee_kernel<false><stream>",
                     "wide_nee_kernel<false><stream>")


def _wide_rows_label(name, found):
    """``name`` of WIDE_ROWS_KERNELS, or in a checkout without kStream
    instantiations the <gate> one that ran past 16 columns there."""
    return name if name in found else name.replace("<stream>", "<gate>")


def wide_rows_case(path, bounce, seed=1, record=False):
    """One launch each of the scene's bounce kernel (its kRecord
    instantiation with the chain factors where ``record``) and NEE kernel
    on the main path's wavefront at ``bounce`` (_bounce_inputs), held to
    the plain version on the same inputs: the state after both against
    tracer.bounce_core's as check_kernels holds it (flags exact, vectors
    rtol 1e-3 / atol 1e-4), with no divergent lane, and with ``record`` the
    camera vertex as check_record_chain holds it (its flags exact on every
    lane, its vectors and chain factors within the tolerance on the lanes
    that reflect). Returns ({output: sha256
    of its bytes}, largest error): the bounce kernel's outputs before the
    NEE kernel adds into the brightness, then that brightness."""
    from pyrite_tpu_torch import kernels_dense as kd, tracer

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, bounce)
    bank = kd.precompute_bank_values(scene, wl)
    t_de = kd.march_pass(scene, cfg, state) if scene.de_shapes else None
    out, ctx, *info = kd.launch_bounce_kernel(scene, cfg, wl, state, draws, bank, t_de, record, record)
    outputs = {f"bounce {k}": v.clone() for k, v in dict(out, **ctx, **(info[0] if record else {})).items()}
    if scene.num_lamps and cfg.light_samples:
        t_de_shadow = kd.shadow_pass(scene, cfg, out, ctx, draws) if scene.de_shapes else None
        kd.launch_nee_kernel(scene, cfg, wl, out, ctx, draws, bank, t_de_shadow)
        outputs["nee brightness"] = out["brightness"]
    plain = tracer.bounce_core(scene, cfg, wl, state, draws, record=record)
    what = f"{os.path.basename(path)} at bounce {bounce}{' (record)' if record else ''}"
    vec_err, b_err, share = _compare(plain[0] if record else plain, out, what)
    assert share == 0.0, f"{what}: {share:.4%} divergent lanes"
    err = max(vec_err, b_err)
    if record:
        ref, got = plain[1], info[0]
        _flags_equal(ref, got, ("is_diffuse", "dispersed", "recorded", "miss", "reflected"), what)
        _flags_equal(ref, got, ("color_prog",), what, ref["reflected"])
        err = max(err, _close_where(ref, got, ("position", "normal", "brdf_stored", "color_prob",
                                               "path_prob"), ref["reflected"], what))
    digests = _digests(outputs)
    print(f"[wide-rows] {what}: {wl.shape[0]} lanes, S={wl.shape[1]}, light_samples="
          f"{cfg.light_samples}: against the plain version max abs err {err:.3g}, flags exact, "
          f"no divergent lane")
    return digests, err


def print_wide_rows_occupancy(s):
    """The bounce and NEE kernels that run a gate scene at S > 16 spectral
    columns (WIDE_ROWS_KERNELS): registers, spill stores / loads, shared
    memory a block (static from ptxas -v; dynamic as the launchers pass
    it, pyrite_bounce_smem, or in a checkout without it the staged rows of
    bounce_smem_bytes) and resident warps a SM (resident_warps), from this
    process's build log (nothing where it loaded a library built before).
    Returns {kernel: (registers, stores, loads, shared bytes, warps)}."""
    from pyrite_tpu_torch import _build, kernels_dense as kd

    regs, static = kernel_registers(_build.build_log), kernel_static_smem(_build.build_log)
    if not regs:
        print(f"[wide-rows] S={s}: no build log in this process, registers not read")
        return {}
    lib = _build.load()

    def dynamic(de):
        if hasattr(lib, "pyrite_bounce_smem"):
            return lib.pyrite_bounce_smem(s, int(de), kd.FORM_GATE)
        return 4 * kd.BLOCK * (4 * s + 12) + (kd._DE_SLOT_BYTES if de else 0)

    found = {}
    for name in WIDE_ROWS_KERNELS:
        r, st, ld = regs[_wide_rows_label(name, regs)]
        smem = static[_wide_rows_label(name, static)] + (
            dynamic("<true>" in name) if "bounce" in name else 0)
        found[name] = (r, st, ld, smem, resident_warps(r, smem))
    print(f"[wide-rows] S={s}: registers, spill stores / loads, shared memory a block, resident "
          f"warps a SM: " + "; ".join(f"{k} {r}, {st}/{ld} B, {sm} B, {w}"
                                       for k, (r, st, ld, sm, w) in found.items()) +
          f" (the simple form's block at S = 16: {4 * kd.BLOCK * (4 * 16 + 12)} B)")
    return found


def _digest_lines(found, against, label):
    """Which outputs of ``found``'s cases are bit-equal to ``against``'s
    (another run's --wide-rows digests)."""
    same = differ = 0
    for case, digests in found.items():
        ref = against.get(case)
        if ref is None:
            continue
        bad = [k for k, v in digests.items() if ref.get(k) != v]
        same += len(digests) - len(bad)
        differ += len(bad)
        print(f"[wide-rows] {case} against {label}: "
              + ("every output bit-equal" if not bad else f"differ: {', '.join(bad)}"))
    print(f"[wide-rows] against {label}: {same} outputs bit-equal, {differ} differ")


def measure_wide_rows(card, save=None, against=None):
    """``--wide-rows [OUT.json [REF.json]]``: the gate form's bounce and
    NEE kernels past 16 spectral columns (their kStream instantiations).
    For each S of WIDE_ROWS_S on the flagship (gate_paths) at bounces 0
    and 1, their outputs against the
    plain version and as digests (wide_rows_case), their per-launch times
    in two windows of 50 launches and their bounds (time_kernels) and their
    registers, shared memory and occupancy (print_wide_rows_occupancy);
    flagship_s24's kRecord bounce the same; the S <= 16 kernels (the
    flagship's simple form, sunlit_terrain_405 and materials_300 in the
    <gate> form) the same; then flagship_s32 at 4 spp and flagship_s64 at 1
    spp through renderers.simple.render under regeneration, profiled
    (profile_render). Writes the digests and times to OUT.json, and given
    REF.json (another checkout's) prints which outputs are bit-equal to it.
    It runs unchanged in a parent's git archive checkout, to compare the
    two in one call (parent, change, change, parent)."""
    started = time.perf_counter()
    found = {"digests": {}, "times": {}, "occupancy": {}}
    with tempfile.TemporaryDirectory() as tmp:
        gate = gate_paths(os.path.join(tmp, "gate"))
        flagship = scene_paths(tmp, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"]
        cases = [(f"flagship_s{s}", gate[f"flagship_s{s}"]) for s in WIDE_ROWS_S] + [
            ("flagship", flagship), ("sunlit_terrain_405", gate["sunlit_terrain_405"]),
            ("materials_300", gate["materials_300"])]
        for s in WIDE_ROWS_S:
            print_occupancy(s)  # the simple instantiations, staged at S columns
            found["occupancy"][s] = print_wide_rows_occupancy(s)
        for name, path in cases:
            for bounce in (0, 1):
                case = f"{name} bounce {bounce}"
                found["digests"][case] = wide_rows_case(path, bounce)[0]
                found["times"][case] = time_kernels(path, card, plain_reps=1, bounce=bounce)
        for bounce in (0, 1):
            found["digests"][f"flagship_s24 record bounce {bounce}"] = wide_rows_case(
                gate["flagship_s24"], bounce, record=True)[0]
        for name, spp in (("flagship_s32", 4), ("flagship_s64", 1)):
            profile_render(gate[name], spp, card, "regen", runs=3)
    for case, times in found["times"].items():
        print(f"[wide-rows] {case} ({card}): " + "; ".join(
            f"{k} {ms:.4f} ms (bound {max(size / HBM_BYTES_PER_S * 1e3, ops / _fp32_rate() * 1e3):.4f})"
            for k, (ms, _, size, ops) in times.items()))
    if save:
        with open(save, "w") as fh:
            json.dump(dict(found, card=card, root=ROOT), fh)
    if against:
        with open(against) as fh:
            _digest_lines(found["digests"], json.load(fh)["digests"], against)
    print(f"[phase] --wide-rows: {time.perf_counter() - started:.1f} s")


# Builds of csrc/bounce.cu that --wide-rows-probes times against the
# build: the streamed bounce pass with 1, 2 or 8 words in flight a thread
# (the build 4), the streamed NEE with two light samples a pass (the build
# 4) or capped at the parent's <gate> registers (9 blocks dense, 7 wide).
_NEE_STREAM_BOUNDS = """template <>
__global__ void __launch_bounds__(BLOCK, 9)
    dense_nee_kernel<false, false, true, true>(const NeeArgs a, const ProgArgs pa) {
  nee_lane<DenseGeo, false, false, true, true>(a, DenseGeo{}, pa);
}
template <>
__global__ void __launch_bounds__(BLOCK, 9)
    dense_nee_kernel<true, false, true, true>(const NeeArgs a, const ProgArgs pa) {
  nee_lane<DenseGeo, true, false, true, true>(a, DenseGeo{}, pa);
}
template <>
__global__ void __launch_bounds__(BLOCK, 7)
    wide_nee_kernel<false, false, true, true>(const NeeArgs a, const WideGeo geo, const ProgArgs pa) {
  nee_lane<WideGeo, false, false, true, true>(a, geo, pa);
}
template <>
__global__ void __launch_bounds__(BLOCK, 7)
    wide_nee_kernel<true, false, true, true>(const NeeArgs a, const WideGeo geo, const ProgArgs pa) {
  nee_lane<WideGeo, true, false, true, true>(a, geo, pa);
}

"""
_LAMP_TEMPLATE = "template <bool kDE, bool kProg>\n__global__ void __launch_bounds__(BLOCK) dense_lamp_kernel("
WIDE_ROWS_VARIANTS = {
    "row_batch_1": [[("constexpr int ROW_BATCH = 4;", "constexpr int ROW_BATCH = 1;")]],
    "row_batch_2": [[("constexpr int ROW_BATCH = 4;", "constexpr int ROW_BATCH = 2;")]],
    "row_batch_8": [[("constexpr int ROW_BATCH = 4;", "constexpr int ROW_BATCH = 8;")]],
    "nee_chunk_2": [[("constexpr int NEE_CHUNK = 4;", "constexpr int NEE_CHUNK = 2;")]],
    "nee_bounds": [[(_LAMP_TEMPLATE, _NEE_STREAM_BOUNDS + _LAMP_TEMPLATE)]],
}


def time_wide_rows_libs(path, libs, order, card, bounce, seed=1):
    """The scene's bounce and NEE kernels through each library of ``libs``
    ({name: (library, build log)}) in ``order``, on the same inputs (the
    main path's wavefront at ``bounce``; the NEE kernel reads the first
    library's bounce outputs and adds into them): ms per launch, two
    windows of 50 after a warm-up. Returns {name: [(bounce ms, NEE ms)]}."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, bounce)
    bank = kd.precompute_bank_values(scene, wl)
    bounce_name, nee_name = kd.kernel_names(scene)
    b_args, out, ctx = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank)
    assert getattr(libs[order[0]][0], kd._LAUNCHERS[bounce_name])(*b_args) == 0
    n_args = kd.nee_kernel_args(scene, cfg, wl, out, ctx, draws, bank)
    found = {}
    for name in order:
        lib = libs[name][0]
        times = []
        for kernel, args in ((bounce_name, b_args), (nee_name, n_args)):
            run = lambda: getattr(lib, kd._LAUNCHERS[kernel])(*args)  # noqa: E731
            for _ in range(2):
                assert run() == 0, f"{name} {kernel}: launch failed"
            torch.cuda.synchronize()
            k1, k2 = _event_ms(run, 50), _event_ms(run, 50)
            times.append((k1 + k2) / 2)
            print(f"[wide-rows-probe] {name} {os.path.basename(path)} {kernel} at bounce {bounce}: "
                  f"{k1:.4f} / {k2:.4f} ms per launch, {wl.shape[0]} lanes, S={wl.shape[1]} ({card})")
        found.setdefault(name, []).append(tuple(times))
    return found


def measure_wide_rows_probes(card, parent_csrc=None):
    """``--wide-rows-probes [PARENT_CSRC]``: the builds of
    WIDE_ROWS_VARIANTS (and of a parent's csrc/ where given) against the
    build: their WIDE_ROWS_KERNELS' registers and spills, and the bounce and
    NEE kernels' times (time_wide_rows_libs) on flagship_s32, flagship_s64,
    sunlit_terrain_405 and materials_300 at bounces 0 and 1 and on the
    flagship at S = 24 with four light samples, in the order parent, build,
    variants, build, parent."""
    from pyrite_tpu_torch import _build

    started = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gate = gate_paths(os.path.join(tmp, "gate"))
        gate["flagship_s24_ls4"] = add_objects(gate["flagship_s24"], [], "flagship_s24_ls4",
                                               [("light_samples = 2", "light_samples = 4")])
        libs = {"build": (_build.load(), _build.build_log)}
        variants = dict(WIDE_ROWS_VARIANTS, **({"parent": parent_csrc} if parent_csrc else {}))
        libs.update(build_variants(os.path.join(tmp, "variants"), variants, tag="wide-rows-probe"))
        for name, (_, log) in libs.items():
            regs, static = kernel_registers(log), kernel_static_smem(log)
            labels = [_wide_rows_label(k, regs) for k in WIDE_ROWS_KERNELS]
            print(f"[wide-rows-probe] {name}: registers, spill stores / loads, static shared "
                  f"memory: " + "; ".join(f"{k} {regs[k][0]}, {regs[k][1]}/{regs[k][2]} B, "
                                         f"{static[k]} B" for k in labels if k in regs))
        ends = ["parent"] if parent_csrc else []
        order = ends + ["build"] + list(WIDE_ROWS_VARIANTS) + ["build"] + ends
        found = {}
        for name, bounces in (("flagship_s32", (0, 1)), ("flagship_s64", (0, 1)),
                              ("flagship_s24_ls4", (0, 1)), ("sunlit_terrain_405", (0, 1)),
                              ("materials_300", (0, 1))):
            for bounce in bounces:
                found[f"{name} bounce {bounce}"] = time_wide_rows_libs(gate[name], libs, order, card,
                                                                       bounce)
    for case, times in found.items():
        print(f"[wide-rows-probe] {case} ({card}), bounce / NEE ms: " + "; ".join(
            f"{name} " + ", ".join(f"{b:.4f} / {n:.4f}" for b, n in runs)
            for name, runs in times.items()))
    print(f"[phase] --wide-rows-probes: {time.perf_counter() - started:.1f} s")


# --- spectral widths past the kernels' old ceilings ----------------------------------------

def wide_paths(directory):
    """The scenes past the kernels' former spectral ceilings (the kProg bounce and
    NEE at 102 columns, the draws at 449, the gather at ~430 fresh
    wavelengths, A's kProg form at ~180): the five renders of phase 9 at the
    CLI's size, textures_s512 (write_textures_scene at 256 x 192, S = 512, 4
    bounces), textures_deep_s128 (its deep colour program at S = 128),
    flagship_s512 (512 x 256, 8 bounces), textures_photon_512
    (photon_scene_paths' textures_photon with a film of 512 bins:
    interpolation mode, a camera walk of S + G = 518 columns and a lamp
    walk of 513) and flagship_bdpt_s128 (8 + 8 bounces at S = 128); and the
    checks' smaller ones, textures_s128 (256 x 192), flagship_s512_small (64
    x 32: the draws held to the CPU), textures_photon_512_small and
    flagship_photon_s512_small (photon_scene_paths(small=True): 4,000
    photons; the gather at K = 512 in exact mode). Returns {name: .lua
    path}."""
    spectra = lambda s: [("spectrum_samples = 6", f"spectrum_samples = {s}")]  # noqa: E731
    sub = lambda name: os.path.join(directory, name)  # noqa: E731
    for name in ("flagship", "small", "bdpt"):
        os.makedirs(sub(name), exist_ok=True)
    size = dict(width=256, height=192, bounces=4, spp=2)
    flagship = scene_paths(sub("flagship"), width=512, height=256, spectrum_samples=6,
                           bounces=8)["flagship"]
    small = photon_scene_paths(sub("photon_small"), small=True)
    return {
        "textures_s512": write_textures_scene(sub("s512"), spectrum_samples=512, **size),
        "textures_s128": write_textures_scene(sub("s128"), spectrum_samples=128, **size),
        "textures_deep_s128": write_textures_scene(sub("deep128"), spectrum_samples=128, deep=True,
                                                   **size),
        "flagship_s512": add_objects(flagship, [], "flagship_s512", spectra(512)),
        "flagship_s512_small": scene_paths(sub("small"), width=64, height=32, spectrum_samples=512,
                                           bounces=4)["flagship"],
        "textures_photon_512": photon_bins_scene(
            photon_scene_paths(sub("photon"))["textures_photon"], 512),
        "textures_photon_512_small": photon_bins_scene(small["textures_photon"], 512),
        "flagship_photon_s512_small": add_objects(small["flagship_photon"], [],
                                                  "flagship_photon_s512", spectra(512)),
        "flagship_bdpt_s128": add_objects(write_flagship_bdpt(sub("bdpt"), "flagship_bdpt", 8, 8),
                                          [], "flagship_bdpt_s128", spectra(128)),
    }


def check_launch_smem(paths):
    """The gate's measures (kernels_dense.launch_smem, the pack's "smem")
    against what the launchers pass at each scene's widths
    (pyrite_bounce_smem, pyrite_bounce_record_smem, pyrite_nee_smem,
    pyrite_draws_smem, pyrite_gather_smem, plus the program stack): equal
    on every scene of ``paths``. Returns the number of measures held."""
    from pyrite_tpu_torch import _build, kernels_dense as kd

    lib = _build.load()
    held = 0
    for name, path in paths.items():
        scene = _gpu_scene(path)[0]
        pack, photon = scene.dense_pack, scene.photon_widths
        widths = (scene.spectrum_samples,) if photon is None else (
            scene.spectrum_samples, photon["camera"], photon["lamp"])
        de, form = int(bool(scene.de_shapes)), pack["form"]
        stack = kd._stack_bytes(form, pack["stack"])
        want = {
            "bounce": max(lib.pyrite_bounce_smem(w, de, form) for w in widths) + stack,
            "record": max(lib.pyrite_bounce_record_smem(w, de, form) for w in widths) + stack,
            "nee": max(lib.pyrite_nee_smem(w, form) for w in widths) + (stack if form == kd.FORM_PROG
                                                                        else 0),
            "draws": lib.pyrite_draws_smem(scene.spectrum_samples),
        }
        if photon is not None:
            k = scene.spectrum_samples
            want["gather"] = lib.pyrite_gather_smem(photon["bins"], k,
                                                    int(kd.gather_out_row(photon["bins"], k)))
        got = {k: pack["smem"][k] for k in want}
        assert got == want, f"{name}: the gate's shared memory {got}, the launchers' {want}"
        held += len(want)
        print(f"[wide] {name} (widths {widths}): the gate's dynamic shared memory a block equals "
              f"the launchers': {want}")
    return held


def wide_step(directory, card):
    """Phase 9: each kernel that had a spectral ceiling, past it,
    against its plain version at a small wavefront (the kProg bounce and
    NEE at S = 128 and 512, with the deep program at 128: check_kernels on
    8,192 and 4,096 lanes; the draws at S = 512 bit for bit against the
    CPU: check_draws; A's kProg form at S + G = 518 and the gate form at
    512, the lamp walk at 513 and the gather at K = 512: check_photon on
    the small photon projects), the gate's measures against the launchers'
    (check_launch_smem), then the five renders of wide_paths through the
    CLI, each with the counts zeroed just before and read just after.
    Returns ({check: largest error}, {render: launch counts})."""
    started = time.perf_counter()
    wide = wide_paths(directory)
    worst = {}
    checked = {name: check_kernels(name, wide[name], lanes=lanes, bounces=2) for name, lanes in (
        ("textures_s128", 8192), ("textures_deep_s128", 8192), ("textures_s512", 4096))}
    divergent = {k: (w["divergent"], w["nee_divergent"]) for k, w in checked.items()
                 if w["divergent"] or w["nee_divergent"]}
    assert not divergent, f"the bounce or NEE kernel diverges from the plain version: {divergent}"
    worst["prog"] = max(max(w["bounce"], w["brightness"]) for w in checked.values())
    worst["prog_nee"] = max(w["nee"] for w in checked.values())
    worst["draws"] = check_draws("flagship_s512_small", wide["flagship_s512_small"])
    photon = {name: check_photon(name, wide[name]) for name in (
        "textures_photon_512_small", "flagship_photon_s512_small")}
    for key in ("record", "lamp", "gather"):
        worst[key] = max(c["worst"][key] for c in photon.values())
    check_launch_smem({k: wide[k] for k in (
        "textures_s512", "textures_deep_s128", "flagship_s512", "textures_photon_512",
        "flagship_bdpt_s128", "flagship_photon_s512_small")})
    runs = {name: render_end_to_end(wide[name], 1, card, directory) for name in (
        "textures_s512", "textures_deep_s128", "flagship_s512")}
    runs["textures_photon_512"] = render_photon(wide["textures_photon_512"], 1, card, directory)[0]
    runs["flagship_bdpt_s128"] = render_bdpt(wide["flagship_bdpt_s128"], 1, card, directory)[0]
    print(f"[wide] past the old ceilings, largest errors against the plain version {worst}")
    print(f"[phase] spectral widths past the old ceilings (phase 9): "
          f"{time.perf_counter() - started:.1f} s")
    return worst, runs


# --- phase 10: the gate's last refusals ---------------------------------------------


def gate_last_paths(directory):
    """Phase 10's scenes, each of a kind the gate refused before:
    planes (write_planes_scene at 512 x 256, S = 6, 8 bounces) and its
    bidirectional twin (4 + 4 bounces); textures_deep80 (the textures
    scene at 256 x 192, S = 6, 4 bounces, its fresnel sphere's colour nested
    77 levels, every second a subtraction: a stack of 80 values in the
    expression's order, past exprs.PROG_STACK_MAX = 48, so lowered in
    Sethi-Ullman order) and its bidirectional twin (256 x 128, 4 + 4
    bounces); textures_deep48 (nested 45 levels: a stack of 48 values in the
    expression's order, the deepest lowered so: --gate-last's); de_1, de_130,
    de_2410 and de_2411 (write_de_many_scene at 128 x 64, S = 4, 3 bounces:
    one shape, the gate's scene, the most shapes a block's shared memory
    staged before march_de_kernel read them from the sheet, and one more);
    flagship_photon at 7,086 and 10,000 film bins (photon_bins_scene at the
    CLI's size: the gather's <out_row> form) and at 7,085 (the most its row
    form holds), and the same three small (photon_scene_paths(small=True):
    the checks and the renders, whose exposures take one scatter a film bin
    and column, ~40 and ~60 s a render at the CLI's size on an H100).
    Returns {name: .lua path}."""
    sub = lambda name: os.path.join(directory, name)  # noqa: E731
    deep = lambda nest, **kw: write_textures_scene(sub(f"deep{nest + 3}"), **kw, deep=nest)  # noqa: E731
    size = dict(width=256, height=192, spectrum_samples=6, bounces=4, spp=4)
    out = {
        "planes": write_planes_scene(sub("planes"), 512, 256, 6, 8, spp=4),
        "planes_bdpt": write_planes_scene(sub("planes"), 512, 256, 6, 4, spp=2,
                                          renderer="bidirectional", light_bounces=4),
        "textures_deep80": deep(77, **size),
        "textures_deep80_bdpt": deep(77, width=256, height=128, spectrum_samples=6, bounces=4,
                                     spp=2, renderer="bidirectional"),
        "textures_deep48": deep(45, **size),
    }
    for count in (1, 130, 2410, 2411):
        out[f"de_{count}"] = write_de_many_scene(directory, count)
    photon = photon_scene_paths(sub("photon"))["flagship_photon"]
    small = photon_scene_paths(sub("photon_small"), small=True)["flagship_photon"]
    for bins in (7085, 7086, 10000):
        out[f"flagship_photon_{bins}"] = photon_bins_scene(photon, bins)
        out[f"flagship_photon_{bins}_small"] = photon_bins_scene(small, bins)
    return out


def _natural_scene(path):
    """_gpu_scene of ``path`` with its programs lowered in the expression's
    order whatever their depth (exprs.PROG_STACK_MAX lifted), cached under
    the path with "#natural"."""
    from pyrite_tpu_torch import exprs

    key = path + "#natural"
    if key not in _SCENES:
        saved = exprs.PROG_STACK_MAX
        exprs.PROG_STACK_MAX = 10 ** 6
        try:
            _SCENES[key] = load_scene(path)
        finally:
            exprs.PROG_STACK_MAX = saved
    return _SCENES[key]


def hold_stack_orders(name, path, lanes=8192, bounces=2, seed=0):
    """The kProg bounce and NEE kernels (kernels_dense.bounce_dense) on a
    scene whose colour program is lowered in Sethi-Ullman order (SWAPs, a
    stack of a few values) and on the same scene lowered in the
    expression's order (a stack of the program's own depth), from the same
    wavefront and draws for ``bounces`` bounces: every output bit for bit.
    Returns the two stacks."""
    import torch

    from pyrite_tpu_torch import exprs, kernels_dense as kd, tracer

    found = []
    for scene, film, camera, cfg in (_gpu_scene(path), _natural_scene(path)):
        origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed, lanes)
        state = tracer.initial_state(origin, direction, wl.shape[1])
        bank = kd.precompute_bank_values(scene, wl)
        states = []
        for b in range(bounces):
            draws = tracer.draw_bounce_uniforms(scene, cfg, origin.shape[0], keyed, b, "cuda")
            state = kd.bounce_dense(scene, cfg, wl, state, draws, bank)
            states.append(state)
        found.append((scene.dense_pack["stack"], states))
    torch.cuda.synchronize()
    (su, ours), (natural, theirs) = found
    swaps = sum(op == exprs.OP_SWAP for op, _, _ in _gpu_scene(path)[0].dense_pack["programs"].code)
    assert su < natural and swaps > 0, (su, natural, swaps)
    for b, (x, y) in enumerate(zip(ours, theirs)):
        for k in x:
            bad = int(_bits_differ(x[k], y[k]).sum())
            assert bad == 0, f"{name} bounce {b}: {k} differs on {bad} entries between the orders"
    print(f"[gate-last] {name}: the kProg bounce and NEE kernels with the colour program in "
          f"Sethi-Ullman order ({swaps} SWAPs, stack {su}) and in the expression's order (stack "
          f"{natural}), {bounces} bounces of {lanes} lanes: every output bit-equal")
    return su, natural


def _spread(n, lanes):
    """``lanes`` indices spread evenly over n: rays from the whole film."""
    import torch

    return torch.linspace(0, n - 1, lanes, device="cuda").long()


def _many_shape_rays(path, lanes, seed=0):
    """``lanes`` rays of a DE scene's camera wavefront (_spread), with the
    bounce kernel's outputs after the march pass and bounce 0's draws:
    (scene, cfg, state, out, ctx, draws)."""
    from pyrite_tpu_torch import kernels_dense as kd, tracer

    scene, film, camera, cfg = _gpu_scene(path)
    origin, direction, wl, keyed = _wavefront(film, camera, cfg, seed)
    pick = _spread(origin.shape[0], lanes)
    origin, direction, wl = origin[pick], direction[pick], wl[pick]
    state = tracer.initial_state(origin, direction, wl.shape[1])
    draws = tracer.draw_bounce_uniforms(scene, cfg, lanes, keyed, 0, "cuda")
    bank = kd.precompute_bank_values(scene, wl)
    out, ctx = kd.launch_bounce_kernel(scene, cfg, wl, state, draws, bank,
                                       kd.march_pass(scene, cfg, state))
    return scene, cfg, state, out, ctx, draws


def _query_rays(scene, out, ctx, draws):
    """A query batch: the NEE lanes' shadow rays of light sample 0, capped
    at the lamp, live where cast (as kernels_dense.shadow_query takes a
    batch)."""
    from pyrite_tpu_torch import kernels_dense as kd

    d, dist, cast = kd.shadow_rays(scene, out, ctx, draws, 0)
    return out["origin"], d.contiguous(), dist.contiguous(), cast


def check_march_shapes(name, path, lanes=512, seed=0):
    """march_de_kernel on ``lanes`` camera rays (_spread) of a scene of
    many DE shapes against the plain version on the card: the bounce pass
    against tracer.de_hits, the shadow pass against
    kernels_dense.shadow_pass_plain, the query pass on the shadow rays
    against de_hits capped at the lamp; t bit-equal on every (shape, ray).
    Returns the largest t error."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd, tracer

    scene, cfg, state, out, ctx, draws = _many_shape_rays(path, lanes, seed)
    origin, direction, dist, live = _query_rays(scene, out, ctx, draws)
    pairs = {
        "bounce": (kd.march_pass(scene, cfg, state), tracer.de_hits(
            scene, state["origin"], state["direction"], cfg.max_de_steps, live=state["alive"])),
        "shadow": (kd.shadow_pass(scene, cfg, out, ctx, draws),
                   kd.shadow_pass_plain(scene, cfg, out, ctx, draws)),
    }
    args, t_q = kd.query_pass_args(scene, cfg, origin, direction, dist, live)
    kd._launch("de_query_pass", args)
    pairs["query"] = (t_q, tracer.de_hits(scene, origin, direction, cfg.max_de_steps, t_cap=dist,
                                           live=live))
    torch.cuda.synchronize()
    worst = 0.0
    for what, (got, plain) in pairs.items():
        bad = int(_bits_differ(got, plain).sum())
        assert bad == 0, f"{name}: the {what} pass's t differs on {bad} of {got.numel()}"
        worst = max(worst, _max_abs_err(got, plain))
        print(f"[gate-last] {name}: march_de_kernel {what} pass, {lanes} rays x "
              f"{len(scene.de_shapes)} DE shapes: t bit-equal to the plain version on "
              f"{got.numel()}/{got.numel()}, {int(torch.isfinite(plain).sum())} hits")
    return worst


def hold_gather_forms(name, path):
    """photon_gather_kernel's <out_row> form against its row form at a bin
    count both run, on one camera bounce's query against pass 0's map of
    ``path``: every output bit-equal. Returns the number of entries held."""
    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd

    spec, pm, q = _gather_inputs(path)
    assert not kd.gather_out_row(spec.bins, spec.spectrum_samples), f"{name}: past the row form"
    lib = _build.load()
    found = []
    for out_row in (False, True):
        args, out = kd.photon_gather_args(spec, pm, q, out_row)
        assert lib.pyrite_photon_gather(*args) == 0, f"{name} out_row={out_row}"
        found.append(out)
    torch.cuda.synchronize()
    held = 0
    for k, got in found[1].items():
        bad = int(_bits_differ(got, found[0][k]).sum())
        assert bad == 0, f"{name}: the gather's {k} differs between its forms on {bad} entries"
        held += got.numel()
    print(f"[gate-last] {name}: photon_gather_kernel<out_row> bit-equal to the row form at "
          f"B={spec.bins}, {q['position'].shape[0]} lanes, {pm['keys'].shape[0]} map entries: "
          f"{held} entries, {int(found[0]['cnt_bins'].sum())} pairs")
    return held


def check_out_row_gather(name, path):
    """photon_gather_kernel's <out_row> form (past the row form's bins)
    against renderers.photon.gather_plain on one camera bounce's query
    against pass 0's map, as _hold_gather holds them. Returns the largest
    error."""
    from pyrite_tpu_torch import kernels_dense as kd
    from pyrite_tpu_torch.renderers import photon as ph

    spec, pm, q = _gather_inputs(path)
    assert kd.gather_out_row(spec.bins, spec.spectrum_samples), f"{name}: within the row form"
    err, same = _hold_gather(f"{name} <out_row> gather", kd.photon_gather(spec, pm, q),
                             ph.gather_plain(spec, pm, q))
    print(f"[gate-last] {name}: photon_gather_kernel<out_row> at B={spec.bins}, "
          f"{q['position'].shape[0]} lanes against the plain version: largest error {err}; "
          f"{_bit_equal(same)}")
    return err


def time_out_row_gather(path, card):
    """photon_gather_kernel's <out_row> form at the CLI's chunk of a
    project past the row form's bins (camera bounce 0 against pass 0's
    map), two windows of 20 launches, and its plain version (one call),
    with _gather_work's bytes and operations. Returns
    {"photon_gather_kernel<out_row>": (kernel ms, plain ms, bytes,
    operations)}."""
    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd
    from pyrite_tpu_torch.renderers import photon as ph

    spec, pm, q = _gather_inputs(path)
    args, _ = kd.photon_gather_args(spec, pm, q)
    lib = _build.load()
    run = lambda: lib.pyrite_photon_gather(*args)  # noqa: E731
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    k1, k2 = _event_ms(run, 20), _event_ms(run, 20)
    ref = ph.gather_plain(spec, pm, q)
    plain_ms = _once_ms(lambda: ph.gather_plain(spec, pm, q))
    size, ops = _gather_work(spec, pm, q, ref)
    print(f"[times] photon_gather_kernel<out_row>: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{plain_ms:.4f} ms (one call), {q['position'].shape[0]} lanes, {pm['keys'].shape[0]} map "
          f"entries, B={spec.bins}, K={spec.spectrum_samples} ({card})")
    result = {"photon_gather_kernel<out_row>": ((k1 + k2) / 2, plain_ms, size, ops)}
    _print_bounds("gate-last", result)
    return result


def gate_last_step(directory, card):
    """Phase 10: the four kinds of scene the gate refused last, on the card.
    Each changed kernel against its plain version at a small wavefront: the
    dense bounce and NEE kernels on planes alone (check_kernels), the kProg
    ones with a program in Sethi-Ullman order (check_kernels; A, B and
    program_colors_kernel through check_bdpt) and bit for bit against the
    expression's order (hold_stack_orders), march_de_kernel at 1, 130 and
    2,411 shapes (check_march_shapes: t bit-equal) and photon_gather's
    <out_row> form at 7,086 and 10,000 bins (check_out_row_gather: counts
    exact) and bit for bit against its row form at 7,085 bins
    (hold_gather_forms); the gate's measures against the launchers'
    (check_launch_smem); the <out_row> gather's time; then the renders
    through the CLI, each with the
    counts zeroed just before and read just after: planes through regen,
    one-shot and BDPT, textures_deep80 through the simple renderer and
    BDPT, de_2411, flagship_photon at 7,086 and 10,000 bins (small). Returns
    ({check: largest error}, {render: launch counts}, {kernel: times})."""
    started = time.perf_counter()
    paths = gate_last_paths(directory)
    worst = {}
    planes = check_kernels("planes", paths["planes"], lanes=16384)
    deep = check_kernels("textures_deep80", paths["textures_deep80"], lanes=8192, bounces=2)
    for what, w in (("planes", planes), ("textures_deep80", deep)):
        assert not (w["divergent"] or w["nee_divergent"]), f"{what}: the kernels diverge {w}"
    worst["dense"], worst["dense_nee"] = max(planes["bounce"], planes["brightness"]), planes["nee"]
    worst["prog"], worst["prog_nee"] = max(deep["bounce"], deep["brightness"]), deep["nee"]
    hold_stack_orders("textures_deep80", paths["textures_deep80"])
    bdpt = check_bdpt("textures_deep80_bdpt", paths["textures_deep80_bdpt"])["worst"]
    for key in ("record", "lamp", "colors"):
        worst[key] = bdpt[key]
    worst["march"] = max(check_march_shapes(f"de_{n}", paths[f"de_{n}"]) for n in (1, 130, 2411))
    worst["out_row"] = max(check_out_row_gather(f"flagship_photon_{b}_small",
                                                paths[f"flagship_photon_{b}_small"])
                           for b in (7086, 10000))
    hold_gather_forms("flagship_photon_7085_small", paths["flagship_photon_7085_small"])
    check_launch_smem({k: paths[k] for k in (
        "planes", "textures_deep80", "de_2411", "flagship_photon_7086", "flagship_photon_10000")})
    times = time_out_row_gather(paths["flagship_photon_10000"], card)
    runs = {
        "planes": render_end_to_end(paths["planes"], 4, card, directory),
        "planes_one_shot": render_end_to_end(paths["planes"], 4, card, directory, which="one-shot"),
        "textures_deep80": render_end_to_end(paths["textures_deep80"], 4, card, directory),
        "de_2411": render_end_to_end(paths["de_2411"], 2, card, directory, passes=True),
    }
    for name in ("planes_bdpt", "textures_deep80_bdpt"):
        runs[name] = render_bdpt(paths[name], 2, card, directory)[0]
    for bins in (7086, 10000):  # the small projects: see gate_last_paths
        runs[f"flagship_photon_{bins}"] = render_photon(paths[f"flagship_photon_{bins}_small"], 1,
                                                        card, directory)[0]
    print(f"[gate-last] the gate's last refusals, largest errors against the plain version {worst}")
    print(f"[phase] the gate's last refusals (phase 10): {time.perf_counter() - started:.1f} s")
    return worst, runs, times


# where a parent checkout's photon gather launcher lacks the form argument
_GATHER_FORM_ARG = 43


def _parent_abi(lib):
    """A parent checkout's library, whose gather launcher takes no form
    argument: its argument types without it."""
    from pyrite_tpu_torch import _build

    sig = list(_build._SIGNATURES["pyrite_photon_gather"])
    del sig[_GATHER_FORM_ARG]
    lib.pyrite_photon_gather.argtypes = sig
    return lib


def measure_gate_last(card, parent_csrc=None, save=None):
    """``--gate-last [PARENT_CSRC [OUT.json]]``: each changed kernel timed
    against its parent's form at a size both run, in one process, through
    this build and (given PARENT_CSRC, another checkout's csrc/, built
    here) the parent's library, in the order parent, build, build, parent:
    the march passes (bounce and shadow) at 1 (fractal.lua), 130 and 2,410
    DE shapes (the parent staged every shape in shared memory, this build
    reads each from the sheet); the gather at 7,085 bins in its row form,
    this build's also in its <out_row> form; the kProg bounce and NEE
    kernels at stacks 8 (textures) and 48 (textures_deep48, the deepest
    lowered in the expression's order), and this build's also on
    textures_deep80 (Sethi-Ullman order); each with its outputs' digests,
    which must agree where the forms compute the same; A, B, C and D
    (time_bdpt) on textures_bdpt through each library and on
    textures_deep80_bdpt through this build. Prints the kProg kernels'
    resident blocks at those stacks. Saves the times to OUT.json."""
    import torch

    from pyrite_tpu_torch import _build, exprs, kernels_dense as kd

    libs = {"build": (_build.load(), _build.build_log)}
    with tempfile.TemporaryDirectory() as tmp:
        if parent_csrc:
            built = build_variants(tmp, {"parent": parent_csrc}, tag="gate-last")
            libs["parent"] = (_parent_abi(built["parent"][0]), built["parent"][1])
            print(f"[gate-last] parent {parent_csrc}: registers and spill stores / loads: " + "; ".join(
                f"{k} {r}, {st}/{ld} B" for k, (r, st, ld) in sorted(
                    kernel_registers(built["parent"][1]).items())))
        order = ["parent", "build", "build", "parent"] if parent_csrc else ["build", "build"]
        paths = gate_last_paths(tmp)
        paths["fractal"] = os.path.join(ROOT, "examples", "fractal.lua")
        paths["textures"] = write_textures_scene(os.path.join(tmp, "textures"), 256, 192, 6, 4,
                                                 spp=4)
        found = {"card": card, "march": {}, "gather": {}, "prog": {}}
        for name in ("fractal", "de_130", "de_2410"):
            scene, cfg, wl, state, draws = _bounce_inputs(paths[name], 1, 0)
            bank = kd.precompute_bank_values(scene, wl)
            out, ctx = kd.launch_bounce_kernel(scene, cfg, wl, state, draws, bank,
                                               kd.march_pass(scene, cfg, state))
            for what, (args, t), launcher in (
                    ("bounce", kd.march_pass_args(scene, cfg, state), "pyrite_de_march_bounce"),
                    ("shadow", kd.shadow_pass_args(scene, cfg, out, ctx, draws),
                     "pyrite_de_march_shadow")):
                digests, times = {}, {}
                for lib in order:
                    run = lambda: getattr(libs[lib][0], launcher)(*args)  # noqa: E731
                    assert run() == 0, f"{name} {what} {lib}: launch failed"
                    torch.cuda.synchronize()
                    digests.setdefault(lib, _digests({"t": t})["t"])
                    k1, k2 = _event_ms(run, 20), _event_ms(run, 20)
                    times.setdefault(lib, []).append((k1 + k2) / 2)
                    print(f"[gate-last] {name} {what} pass {lib}: {k1:.4f} / {k2:.4f} ms per launch, "
                          f"{state['origin'].shape[0]} lanes x {len(scene.de_shapes)} DE shapes ({card})")
                assert len(set(digests.values())) == 1, f"{name} {what}: the forms differ {digests}"
                found["march"][f"{name} {what}"] = times
        spec, pm, q = _gather_inputs(paths["flagship_photon_7085"])
        row, out_row = (kd.photon_gather_args(spec, pm, q, form) for form in (False, True))
        parent_row = row[0][:_GATHER_FORM_ARG] + row[0][_GATHER_FORM_ARG + 1:]
        runs = {lib: (lambda lib=lib: getattr(libs[lib][0], "pyrite_photon_gather")(
            *(parent_row if lib == "parent" else row[0]))) for lib in libs}
        runs["build <out_row>"] = lambda: libs["build"][0].pyrite_photon_gather(*out_row[0])
        digests, times = {}, {}
        for lib in order + ["build <out_row>", "build <out_row>"]:
            assert runs[lib]() == 0, f"gather {lib}: launch failed"
            torch.cuda.synchronize()
            digests.setdefault(lib, _digests(out_row[1] if "out_row" in lib else row[1]))
            k1, k2 = _event_ms(runs[lib], 20), _event_ms(runs[lib], 20)
            times.setdefault(lib, []).append((k1 + k2) / 2)
            print(f"[gate-last] flagship_photon_7085 gather {lib}: {k1:.4f} / {k2:.4f} ms per launch, "
                  f"{q['position'].shape[0]} lanes, {pm['keys'].shape[0]} map entries, "
                  f"B={spec.bins} ({card})")
        assert all(d == digests["build"] for d in digests.values()), f"gather forms differ {digests}"
        found["gather"]["flagship_photon_7085"] = times
        for name in ("textures", "textures_deep48"):
            digests, times = _prog_libs(name, paths[name], libs, order, card, 0)
            assert all(d == digests["build"] for d in digests.values()), f"{name}: {digests}"
            found["prog"][f"{name} stack {_gpu_scene(paths[name])[0].dense_pack['stack']}"] = times
        _, times = _prog_libs("textures_deep80", paths["textures_deep80"], {"build": libs["build"]},
                              ["build", "build"], card, 0)
        stack = _gpu_scene(paths["textures_deep80"])[0].dense_pack["stack"]
        found["prog"][f"textures_deep80 stack {stack}"] = times
        # A, B, C and D on the textures BDPT scene (stack 8) through each
        # library, and on textures_deep80_bdpt (Sethi-Ullman) through this build
        found["bdpt"] = {}
        tex_bdpt = write_textures_scene(os.path.join(tmp, "textures_bdpt"), 512, 256, 6, 4, spp=2,
                                        renderer="bidirectional")
        for name, path, runs in (("textures_bdpt", tex_bdpt, order),
                                 ("textures_deep80_bdpt", paths["textures_deep80_bdpt"],
                                  ["build", "build"])):
            checked = check_bdpt(name, path)
            for lib in runs:
                found["bdpt"].setdefault(name, {}).setdefault(lib, []).append(
                    time_bdpt(checked, card, variant=(f"{name} {lib}", libs[lib][0])))
        for stack in (exprs.PROG_STACK, exprs.PROG_STACK_MAX):
            found[f"occupancy stack {stack}"] = print_occupancy(6, stack)
    if save:
        with open(save, "w") as fh:
            json.dump(found, fh, indent=1)
        print(f"[gate-last] times saved to {save}")
    return found


# csrc/draws.cu edited for --wide-prog's probe draws_staged: camera rows of
# more than CAM_STAGED words staged CAM_STAGED words at a time at a stride
# of CAM_STAGED + 1, each window stored a warp a row, in place of the
# Philox blocks stored straight.
_DRAWS_STRAIGHT = """    } else {  // a Philox block a thread, its words stored straight: no row staged
      const int nb = (w + 3) / 4;
      for (int i = threadIdx.x; i < rows * nb; i += BLOCK) {
        const int r = i / nb, b = i - r * nb, l = base + r;
        const unsigned px = a.pixel ? (unsigned)a.pixel[l] : a.pixel0 + (unsigned)(l % a.n_pix);
        const unsigned sm = a.pixel ? (unsigned)a.sample[l] : a.sample0 + (unsigned)(l / a.n_pix);
        const uint4 x = !a.cam_mask || a.cam_mask[l]
                            ? philox4x32_10(make_uint4(px, sm, 0u, ((unsigned)P_CAMERA << 16) | b),
                                            a.k0, a.k1)
                            : make_uint4(0u, 0u, 0u, 0u);
        float* dst = a.cam_out + (size_t)l * w + 4 * b;
        for (int q = 0; q < 4 && 4 * b + q < w; ++q) dst[q] = uniform(word(x, q));
      }
    }
"""
_DRAWS_STAGED = """    } else {  // CAM_STAGED words a lane at a time, each window stored as its rows' runs
      for (int from = 0; from < w; from += CAM_STAGED) {
        const int cw = min(CAM_STAGED, w - from);
        if (in_range)
          for (int b = from / 4; 4 * b < from + cw; ++b) {
            const uint4 x = drawn ? philox4x32_10(
                make_uint4(pixel, sample, 0u, ((unsigned)P_CAMERA << 16) | b), a.k0, a.k1)
                                  : make_uint4(0u, 0u, 0u, 0u);
            for (int q = 0; q < 4 && 4 * b + q < from + cw; ++q)
              stage[threadIdx.x * (CAM_STAGED + 1) + 4 * b + q - from] = uniform(word(x, q));
          }
        __syncthreads();
        // a warp a row at a time, its lanes on consecutive words
        for (int r = threadIdx.x >> 5; r < rows; r += BLOCK / 32)
          for (int c = threadIdx.x & 31; c < cw; c += 32)
            a.cam_out[(size_t)(base + r) * w + from + c] = stage[r * (CAM_STAGED + 1) + c];
        __syncthreads();
      }
    }
"""
# csrc/bounce.cu edited for --wide-prog's probes: the camera walk's own rows
# in chunks of 16 or 64 columns (the build 128; the simple renderer's 16,
# which measured faster than 32 and 64: PERF.md), the draws' camera rows
# staged in chunks (draws_staged, csrc/draws.cu), and own_scratch, the kProg
# streamed bounce past 16 columns making each own row whole into an [N, S]
# device scratch (one buffer, grown by the launchers), which bounce_rows
# reads as it reads the sky rows, in place of the chunks.
_OWN_LANE = ("  } else if (kChunks && own_prog >= 0) {  // the lane code now, the columns chunk by chunk\n"
             "    eval_program(pr, pa, own_prog, lane, n, s, 0, in, nullptr, -1, &own_slots);\n")
_OWN_SCRATCH_LANE = ("  } else if (kChunks && own_prog >= 0) {  // the whole row into the scratch\n"
                     "    row_src = g_own_scratch + (size_t)lane * s;\n"
                     "    eval_program(pr, pa, own_prog, lane, n, s, s, in, g_own_scratch + (size_t)lane * s);\n")
_BOUNCE_LANE = ("template <class Geo, bool kDE, bool kRecord, bool kProg, bool kGate, bool kStream, "
                "bool kWhole>\n__device__ __forceinline__ void bounce_lane(")
_NAMESPACE_END = '}  // namespace\n\nextern "C" {\n'
_GROW_SCRATCH = """// own_scratch: the [N, S] scratch, grown where a launch needs more
void grow_own_scratch(size_t floats) {
  static float* buf = nullptr;
  static size_t have = 0;
  if (floats <= have) return;
  cudaFree(buf);
  cudaMalloc(&buf, floats * sizeof(float));
  have = floats;
  cudaMemcpyToSymbol(g_own_scratch, &buf, sizeof(buf));
}

"""
WIDE_PROG_VARIANTS = {
    "record_chunk_16": [[("constexpr int RECORD_CHUNK = 128;", "constexpr int RECORD_CHUNK = 16;")]],
    "record_chunk_64": [[("constexpr int RECORD_CHUNK = 128;", "constexpr int RECORD_CHUNK = 64;")]],
    "draws_staged": [[
        (_DRAWS_STRAIGHT, _DRAWS_STAGED, "draws.cu"),
        ("  const int w = s_cam + 5 <= CAM_STAGED ? s_cam + 5 : 3;",
         "  const int w = s_cam + 5 <= CAM_STAGED ? s_cam + 5 : CAM_STAGED + 1;", "draws.cu"),
    ]],
    "own_scratch": [[
        (_OWN_LANE, _OWN_SCRATCH_LANE),
        ("  if constexpr (kChunks) {\n    // per chunk:", "  if constexpr (false) {\n    // per chunk:"),
        (_BOUNCE_LANE, "__device__ float* g_own_scratch;  // own_scratch's rows\n\n" + _BOUNCE_LANE),
        (_NAMESPACE_END, _GROW_SCRATCH + _NAMESPACE_END),
        ("  const size_t own = BOUNCE_SMEM;\n",
         "  const size_t own = BOUNCE_SMEM;\n  if (form == FORM_PROG && WIDE) grow_own_scratch((size_t)n * s);\n"),
        ("  const size_t own = RECORD_SMEM;\n",
         "  const size_t own = RECORD_SMEM;\n  if (form == FORM_PROG && WIDE) grow_own_scratch((size_t)n * s);\n"),
        ("stream_smem_bytes(n_de > 0, OWN_STRIDE)", "stream_smem_bytes(n_de > 0)"),
        ("#define RECORD_SMEM stream_smem_bytes(n_de > 0, form == FORM_PROG ? OWN_FLOATS(RECORD_STRIDE) : 0)",
         "#define RECORD_SMEM stream_smem_bytes(n_de > 0, form == FORM_PROG && !WIDE ? s : 0)"),
    ]],
}
# csrc/bounce.cu edited back to the staged kProg form past 16 columns:
# the simple renderer's kProg bounce and NEE staged at [BLOCK, S] at any S
# (the card tests hold the chunked forms to it bit for bit).
PROG_STAGED_FORM = [[
    ("(form == FORM_PROG   ? (WIDE ? &K<__VA_ARGS__, true, true, true> : &K<__VA_ARGS__, true, true, false>)",
     "(form == FORM_PROG   ? &K<__VA_ARGS__, true, true, false>"),
    ("  (form == FORM_PROG && WIDE ? stream_smem_bytes(n_de > 0, OWN_STRIDE)",
     "  (false ? stream_smem_bytes(n_de > 0, OWN_STRIDE)"),
    ("#define NEE_SMEM (form == FORM_PROG ? (size_t)BLOCK * OWN_FLOATS(OWN_STRIDE) * sizeof(float) : 0)",
     "#define NEE_SMEM (form == FORM_PROG ? (size_t)BLOCK * s * sizeof(float) : 0)"),
]]
# The widths at which --wide-prog holds the kProg bounce and NEE to a
# parent's build (which staged them up to 102 columns), and past it
WIDE_PROG_S = (24, 64, 102)
WIDE_PROG_PAST = (128, 512)


def wide_prog_paths(directory):
    """--wide-prog's scenes: the textures scene (256 x 192, 4 bounces) at
    each S of WIDE_PROG_S and WIDE_PROG_PAST, textures_512 (the wide kProg
    kernels) at S = 64 and 128, textures_photon at 64, 128 and 512 film bins
    (A's kProg form at S + G = 70, 134 and 518 columns), flagship_photon at
    S = 6, 64, 128 and 512 (the gather's K; 512 on the small project, and
    at full size as flagship_photon_s512_full) and the flagship at S = 6,
    128, 449 and 512 (the draws' camera rows). Returns {name: .lua path}."""
    size = dict(width=256, height=192, bounces=4, spp=2)
    spectra = lambda s: [("spectrum_samples = 6", f"spectrum_samples = {s}")]  # noqa: E731
    os.makedirs(directory, exist_ok=True)
    out = {f"textures_s{s}": write_textures_scene(os.path.join(directory, f"t{s}"),
                                                  spectrum_samples=s, **size)
           for s in WIDE_PROG_S + WIDE_PROG_PAST}
    out.update({f"textures_512_s{s}": write_textures_scene(os.path.join(directory, f"w{s}"),
                                                           spectrum_samples=s, tiles=(16, 16), **size)
                for s in (64, 128)})
    photon = photon_scene_paths(os.path.join(directory, "photon"))
    small = photon_scene_paths(os.path.join(directory, "photon_small"), small=True)
    out.update({f"textures_photon_{b}": photon_bins_scene(photon["textures_photon"], b)
                for b in (64, 128, 512)})
    out["flagship_photon_s6"] = photon["flagship_photon"]
    out.update({f"flagship_photon_s{s}": add_objects(photon["flagship_photon"], [],
                                                     f"flagship_photon_s{s}", spectra(s))
                for s in (64, 128)})
    out["flagship_photon_s512"] = add_objects(small["flagship_photon"], [], "flagship_photon_s512",
                                              spectra(512))
    out["flagship_photon_s512_full"] = add_objects(photon["flagship_photon"], [],
                                                   "flagship_photon_s512", spectra(512))
    flagship = scene_paths(directory, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"]
    out.update({f"flagship_s{s}": add_objects(flagship, [], f"flagship_s{s}", spectra(s))
                for s in (6, 128, 449, 512)})
    return out


def _prog_libs(label, path, libs, order, card, bounce, seed=1):
    """The scene's bounce kernel, then its NEE kernel, through each library
    of ``libs`` in ``order`` on the same inputs (the main path's wavefront
    at ``bounce``; each NEE launch from the build's bounce outputs): their
    outputs' digests and ms per launch (_time_libs). Returns ({library:
    digests}, {library: [(bounce ms, NEE ms)]})."""
    import torch

    from pyrite_tpu_torch import kernels_dense as kd

    scene, cfg, wl, state, draws = _bounce_inputs(path, seed, bounce)
    bank = kd.precompute_bank_values(scene, wl)
    bounce_name, nee_name = kd.kernel_names(scene)
    b_args, out, ctx = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank)
    digests, b_times = _time_libs(f"{label} bounce {bounce} {bounce_name}", kd._LAUNCHERS[bounce_name],
                                  b_args, dict(out, **ctx), libs, order, card)
    assert getattr(libs["build"][0], kd._LAUNCHERS[bounce_name])(*b_args) == 0
    keep = out["brightness"].clone()
    n_args = kd.nee_kernel_args(scene, cfg, wl, out, ctx, draws, bank)
    times = {}
    for name in order:
        run = lambda: getattr(libs[name][0], kd._LAUNCHERS[nee_name])(*n_args)  # noqa: E731
        out["brightness"].copy_(keep)
        assert run() == 0, f"{label} {name} {nee_name}: launch failed"
        torch.cuda.synchronize()
        digests[name].setdefault("nee brightness", _digests({"b": out["brightness"]})["b"])
        k1, k2 = _event_ms(run, 50), _event_ms(run, 50)
        times.setdefault(name, []).append((b_times[name][len(times.get(name, []))], (k1 + k2) / 2))
        print(f"[wide-prog] {label} bounce {bounce} {nee_name} {name}: {k1:.4f} / {k2:.4f} ms per "
              f"launch, {wl.shape[0]} lanes, S={wl.shape[1]} ({card})")
    return digests, times


def _draws_libs(label, path, libs, order, card, seed=5):
    """The regeneration iteration's lane_draws (camera rows of S + 5 words
    on a mask of ~30 % of the lanes, bounce draws at each lane's depth) of
    ``path`` at the regeneration width, through each library in ``order``
    on the same arguments (time_draws' indexed launch): digests of the
    camera rows and the bounce draws, ms per launch (_time_libs)."""
    import torch

    from pyrite_tpu_torch import rng
    from pyrite_tpu_torch.renderers.simple import _regen_planes

    scene, film, camera, cfg = _gpu_scene(path)
    ls, lamps, s = cfg.light_samples, scene.num_lamps, cfg.spectrum_samples
    keys, mask = _lane_keys(film, _regen_planes(film), cfg.bounces, seed)
    m = keys.pixel.shape[0]
    m_words, _ = rng._layout(m, ls, lamps)
    cam = torch.empty((m, s + 5), dtype=torch.float32, device="cuda")
    out = torch.empty(m_words, dtype=torch.float32, device="cuda")
    k0, k1 = keys.key()
    args = (k0, k1, m, 1, 0, 0, 0, s, ls, lamps, cam.data_ptr(), out.data_ptr(),
            keys.pixel.data_ptr(), keys.sample.data_ptr(), keys.depth.data_ptr(),
            mask.view(torch.uint8).data_ptr(), 0, 0, 0, 0, torch.cuda.current_stream().cuda_stream)
    return _time_libs(f"{label} philox_draws_kernel ({m} lanes, S={s})", "pyrite_philox_draws", args,
                      {"camera": cam, "bounce": out}, libs, order, card)


def _gather_inputs(path, seed=0):
    """One camera bounce's gather query (the first) of ``path``'s first
    chunk against pass 0's map, as check_photon makes it, without the
    plain checks: (spec, map, query)."""
    from pyrite_tpu_torch import rng
    from pyrite_tpu_torch.renderers import photon as ph

    (pd, scene, parts, rows, pm, photon_draws, cam_draws, rays, wl_ext,
     bank) = _photon_setup(path, seed)
    cfg, spec = parts[2], parts[4]
    _, origin, direction, wl = rays
    n = wl.shape[0]
    chain_m = len(scene.color_programs) if spec.exact else None
    _, vertices = ph._record_camera_vertices(scene, cfg, cam_draws, origin, direction, wl_ext, bank,
                                             chain_m)
    lam0 = wl_ext[:, 0].contiguous()
    factors0 = ph._log_factors(scene, lam0) if spec.exact else None
    lam_f, _ = rng.fresh_wavelengths(photon_draws, n, 0, spec.spectrum_samples, spec.span,
                                     scene.device)
    return spec, pm, ph.gather_query(scene, vertices[0], spec, lam0, lam_f, factors0)


def time_wide(card, paths, gather_small):
    """The changed kernels' per-launch times past their old ceilings with
    their plain versions' and their bounds (bytes and FP32 operations that
    the run's inputs need): the kProg bounce and NEE on the textures scene
    at S = 128 and 512, bounces 0 and 1 (time_kernels), A's kProg form at S
    + G = 518 (time_record_form), the draws at S = 512 (time_draws) and the
    gather at K = 512 on the small project (time_photon on
    ``gather_small``, check_photon's) and at full size, the kernel alone
    (its bound from its own counts: the plain gather at K = 512 over
    131,072 lanes is not timed). Returns {case: {kernel: (ms, plain ms or
    None, bytes, operations)}}."""
    import torch

    from pyrite_tpu_torch import _build, kernels_dense as kd

    found = {}
    for name in ("textures_s128", "textures_s512"):
        for bounce in (0, 1):
            found[f"{name} bounce {bounce}"] = time_kernels(paths[name], card, plain_reps=1,
                                                           bounce=bounce)
    found["textures_photon_512 record"] = {"dense_bounce_kernel<record,prog>": time_record_form(
        paths["textures_photon_512"], True, card)}
    found["flagship_s512 draws"] = time_draws(paths["flagship_s512"], card)
    found["flagship_photon_s512 gather (small)"] = time_photon(gather_small, card)
    spec, pm, q = _gather_inputs(paths["flagship_photon_s512_full"])
    args, out = kd.photon_gather_args(spec, pm, q)
    run = lambda: _build.load().pyrite_photon_gather(*args)  # noqa: E731
    for _ in range(2):
        assert run() == 0
    torch.cuda.synchronize()
    k1, k2 = _event_ms(run, 20), _event_ms(run, 20)
    size, ops = _gather_work(spec, pm, q, out)
    found["flagship_photon_s512 gather"] = {"photon_gather_kernel": ((k1 + k2) / 2, None, size, ops)}
    print(f"[times] photon_gather_kernel at K = 512: {k1:.4f} / {k2:.4f} ms per launch, "
          f"{q['position'].shape[0]} lanes, {pm['keys'].shape[0]} map entries ({card})")
    for case, times in found.items():
        print(f"[wide-prog] {case} ({card}): " + "; ".join(
            f"{k} {ms:.4f} ms, plain {plain if plain is None else round(plain, 4)} ms, bound "
            f"{_bound_ms(size, ops)[0]:.4f} ms by {_bound_ms(size, ops)[1]}"
            for k, (ms, plain, size, ops) in times.items()))
    return found


def measure_wide_prog(card, parent_csrc=None, save=None):
    """``--wide-prog [PARENT_CSRC [OUT.json]]``: the kernels that take any
    spectral width, against a parent's build where it ran and against their plain
    version past it, with the probe builds of WIDE_PROG_VARIANTS
    beside the build: the kProg bounce and NEE on the textures scene at S
    of WIDE_PROG_S (parent) and WIDE_PROG_PAST, and the wide ones on
    textures_512 at 64 and 128, at bounces 0 and 1 (_prog_libs; the build
    also against the plain version, wide_rows_case); A's kProg form on
    textures_photon at S + G = 70, 134 (parent) and 518 (check_record_form
    and its bounce-0 launch timed); the draws on the flagship at S = 6,
    128, 449 (parent) and 512 (_draws_libs; check_draws holds 512 to the
    CPU on a small film); the gather on flagship_photon at K = 6, 64, 128
    (parent) and 512 (_gather_inputs; check_photon holds 512 to the plain
    version). Timed in the order parent, build, probes, build, parent (the
    draws past 87 columns parent, build, draws_staged, build, parent, the
    other draws and the gather parent, build, build, parent). Prints the
    registers and spills of each build's
    kernels, which outputs are bit-equal to the parent's, and the times;
    writes them to OUT.json."""
    from pyrite_tpu_torch import _build

    started = time.perf_counter()
    found = {"digests": {}, "times": {}, "errors": {}, "card": card}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"build": (_build.load(), _build.build_log)}
        variants = dict(WIDE_PROG_VARIANTS, **({"parent": parent_csrc} if parent_csrc else {}))
        libs.update(build_variants(os.path.join(tmp, "variants"), variants, tag="wide-prog"))
        for name, (_, log) in libs.items():
            regs = kernel_registers(log)
            found.setdefault("registers", {})[name] = regs
            print(f"[wide-prog] {name}: registers, spill stores / loads: " + "; ".join(
                f"{k} {r}, {st}/{ld} B" for k, (r, st, ld) in sorted(regs.items())))
        ends = ["parent"] if parent_csrc else []
        probes = list(WIDE_PROG_VARIANTS)
        paths = wide_prog_paths(tmp)

        def case(key, result):
            digests, times = result
            found["digests"][key], found["times"][key] = digests, times

        for s in WIDE_PROG_S + WIDE_PROG_PAST:
            order = (ends if s in WIDE_PROG_S else []) + ["build"] + probes + ["build"] + (
                ends if s in WIDE_PROG_S else [])
            for bounce in (0, 1):
                found["errors"][f"textures_s{s} bounce {bounce}"] = wide_rows_case(
                    paths[f"textures_s{s}"], bounce)[1]
                case(f"textures_s{s} bounce {bounce}", _prog_libs(
                    f"textures_s{s}", paths[f"textures_s{s}"], libs, order, card, bounce))
        for s in (64, 128):
            order = (ends if s == 64 else []) + ["build"] + probes + ["build"] + (
                ends if s == 64 else [])
            found["errors"][f"textures_512_s{s}"] = wide_rows_case(paths[f"textures_512_s{s}"], 0)[1]
            case(f"textures_512_s{s} bounce 0", _prog_libs(
                f"textures_512_s{s}", paths[f"textures_512_s{s}"], libs, order, card, 0))
        for bins in (64, 128, 512):
            within = bins < 512 and parent_csrc
            path = paths[f"textures_photon_{bins}"]
            rec_libs = {k: v for k, v in libs.items() if k != "parent" or within}
            digests, err = check_record_form(f"textures_photon_{bins}", path, True, rec_libs)
            found["errors"][f"textures_photon_{bins} record"] = err
            for b, d in digests.items():
                found["digests"][f"textures_photon_{bins} record bounce {b}"] = d
            from pyrite_tpu_torch import kernels_dense as kd

            scene, cfg, wl, bank, bounces = record_inputs(path, True)
            state, draws, t_de = bounces[0]
            args, out, ctx, info = kd.bounce_kernel_args(scene, cfg, wl, state, draws, bank, t_de,
                                                         True, True)
            order = (ends if within else []) + ["build"] + probes + ["build"] + (ends if within else [])
            _, times = _time_libs(f"textures_photon_{bins} record (S + G = {wl.shape[1]})",
                                  kd._LAUNCHERS[kd.record_name(scene)], args,
                                  dict(out, **ctx), libs, order, card)
            found["times"][f"textures_photon_{bins} record"] = times
        found["errors"]["draws S=512"] = check_draws("flagship_s512", paths["flagship_s512"])
        for s in (6, 128, 449, 512):
            mid = ["build", "draws_staged", "build"] if s > 87 else ["build", "build"]
            order = (ends if s < 512 else []) + mid + (ends if s < 512 else [])
            case(f"draws S={s}", _draws_libs(f"flagship_s{s}", paths[f"flagship_s{s}"], libs, order,
                                             card))
        gather_512 = check_photon("flagship_photon_s512", paths["flagship_photon_s512"])
        found["errors"]["gather K=512"] = gather_512["worst"]["gather"]
        from pyrite_tpu_torch import kernels_dense as kd

        for k in (6, 64, 128, 512):
            spec, pm, q = _gather_inputs(paths[f"flagship_photon_s{k}"])
            args, out = kd.photon_gather_args(spec, pm, q)
            order = (ends if k < 512 else []) + ["build", "build"] + (ends if k < 512 else [])
            case(f"gather K={k}", _time_libs(
                f"flagship_photon_s{k} photon_gather_kernel ({q['position'].shape[0]} vertices, "
                f"{pm['keys'].shape[0]} photons, K={k})", "pyrite_photon_gather", args, out, libs,
                order, card))
        found["bounds"] = time_wide(card, paths, gather_512)
    same = differ = 0
    for key, digests in found["digests"].items():
        for other in [k for k in digests if k != "build"]:
            bad = [k for k, v in digests["build"].items() if digests[other].get(k) != v]
            if other == "parent":
                same, differ = same + len(digests["build"]) - len(bad), differ + len(bad)
            print(f"[wide-prog] {key}, {other} against the build: " + (
                "every output bit-equal" if not bad else f"differ: {', '.join(bad)}"))
    print(f"[wide-prog] against the parent: {same} outputs bit-equal, {differ} differ")
    for key, times in found["times"].items():
        print(f"[wide-prog] {key} ({card}), ms per launch: " + "; ".join(
            f"{name} " + ", ".join(str(t) for t in runs) for name, runs in times.items()))
    print(f"[wide-prog] largest errors against the plain version: {found['errors']}")
    if save:
        with open(save, "w") as fh:
            json.dump(found, fh)
    print(f"[phase] --wide-prog: {time.perf_counter() - started:.1f} s")


def main(argv=None):
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    kind, smi, clock = _gpu_info()
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; max SM clock "
          f"{clock:.0f} MHz")
    print(smi)

    from pyrite_tpu_torch import _build

    if not argv:  # the main run builds from clean; a mode reuses a build of the same sources
        shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    started = time.perf_counter()
    _build.load()
    print(f"[build] {len(_build.sources())} source(s) -> {_build.library_path()} "
          f"in {time.perf_counter() - started:.2f} s")
    _print_registers(_build.build_log)
    if argv == ["--profile"]:
        profile_renders(smi)
        profile_bdpt(smi)
        profile_photon(smi)
        return 0
    if argv == ["--walls"]:
        profile_renders(smi, flagship_only=True)
        return 0
    if argv == ["--regen"]:
        with tempfile.TemporaryDirectory() as tmp:
            small = os.path.join(tmp, "cornell_64")
            os.makedirs(small)
            regen_bdpt_step(bdpt_scene_paths(tmp, spp=2), write_cornell_scene(small, 64, 64, spp=2),
                            smi, tmp)
        profile_bdpt(smi, only=("flagship_bdpt_deep", "flagship_bdpt_64", "flagship_bdpt_256"))
        return 0
    if argv == ["--multi"]:
        with tempfile.TemporaryDirectory() as tmp:
            flagship = scene_paths(tmp, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"]
            multi_device_step(flagship, write_flagship_bdpt(tmp, "flagship_bdpt_deep", 16, 8),
                              photon_scene_paths(os.path.join(tmp, "photon"))["flagship_photon"],
                              smi, tmp)
            cards_probe(flagship, smi, tmp, os.path.join(tmp, "trace"), ["cuda:0", "cuda:0"], "gloo")
        return 0
    if argv == ["--cards"]:
        with tempfile.TemporaryDirectory() as tmp:
            multi_card_step(smi, tmp)
        return 0
    if argv == ["--photon"]:
        photon_step(smi)
        return 0
    if argv in (["--bdpt"], ["--bdpt-probes"]):
        bdpt_step(smi, probes=argv == ["--bdpt-probes"])
        return 0
    if argv == ["--prog"]:
        measure_prog(smi)
        return 0
    if argv[:1] == ["--wide-rows"] and len(argv) <= 3:
        measure_wide_rows(smi, *argv[1:])
        return 0
    if argv[:1] == ["--wide-rows-probes"] and len(argv) <= 2:
        measure_wide_rows_probes(smi, *argv[1:])
        return 0
    if argv[:1] == ["--wide-prog"] and len(argv) <= 3:
        measure_wide_prog(smi, *argv[1:])
        return 0
    if argv[:1] == ["--gate-last"] and len(argv) <= 3:
        measure_gate_last(smi, *argv[1:])
        return 0
    if argv[:1] in (["--record-rows"], ["--rows"]) and len(argv) <= 3:
        parent, save = (argv[1:] + [None, None])[:2]
    if argv[:1] == ["--record-rows"] and len(argv) <= 3:
        with tempfile.TemporaryDirectory() as tmp:
            measure_record_rows(smi, tmp, parent, save)
        return 0
    if argv[:1] == ["--rows"] and len(argv) <= 3:
        with tempfile.TemporaryDirectory() as tmp:
            flagship = scene_paths(tmp, width=512, height=256, spectrum_samples=6, bounces=8)["flagship"]
            measure_rows(flagship, os.path.join(ROOT, "examples", "fractal.lua"), smi)
            time_kernels(texture_paths(os.path.join(tmp, "textures"))["textures"], smi, plain_reps=1)
            measure_record_rows(smi, tmp, parent, save)
            measure_bank(gate_paths(os.path.join(tmp, "gate"))["materials_300"], smi, tmp)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    with tempfile.TemporaryDirectory() as tmp:
        phases_started = time.perf_counter()
        paths = scene_paths(tmp, width=512, height=256, spectrum_samples=6, bounces=8)
        de = {"fractal": os.path.join(ROOT, "examples", "fractal.lua"),
              "julia": write_julia_scene(tmp)}
        mixed = {"terrain_de_24": write_terrain_de_scene(tmp, width=128, height=64),
                 "two_de": write_two_de_scene(tmp)}
        mesh = terrain_paths(tmp)
        drawn = {name: check_draws(name, p) for name, p in (("flagship", paths["flagship"]),
                                                              ("fractal", de["fractal"]))}
        marched = {name: check_march(name, p) for name, p in dict(de, **mixed).items()}
        shadowed = {name: check_shadow_pass(name, p) for name, p in dict(de, **mixed).items()}
        worst = {name: check_kernels(name, p) for name, p in dict(paths, **de, **mixed).items()}
        divergent = {k: (w["divergent"], w["nee_divergent"]) for k, w in worst.items()
                     if w["divergent"] or w["nee_divergent"]}
        assert not divergent, f"the bounce or NEE kernel diverges from the plain version: {divergent}"
        shadow = {name: de_shadow_share(name, p) for name, p in de.items()}
        worst_wide = check_kernels("terrain_405", mesh["terrain_405"])
        queries = {name: check_queries(name, p) for name, p in mesh.items()}
        times = measure_rows(paths["flagship"], de["fractal"], smi)
        times.update(time_draws(paths["flagship"], smi))
        times.update(time_march(de["fractal"], smi))
        times.update(time_kernels(mesh["terrain_405"], smi, plain_reps=2))
        time_kernels(mesh["terrain_405"], smi, plain_reps=2, bounce=1)  # printed
        times.update(time_queries(mesh["terrain_405"], smi))
        time_queries(mesh["terrain_660"], smi)  # printed: the larger leaf's cost
        # the schedulers against each other: the same film
        terrain_24 = terrain_paths(tmp, cells=(24,))["terrain_24"]
        same = {name: compare_schedulers(name, p, 4, smi)
                for name, p in (("flagship", paths["flagship"]), ("terrain_24", terrain_24))}
        # the main path: the CLI through regeneration (the default), and
        # prism.lua's 16 bounces through the pool with regeneration off
        dense_runs = [render_end_to_end(paths["flagship"], 16, smi, tmp),
                      render_end_to_end(paths["prism"], 8, smi, tmp),
                      render_end_to_end(paths["prism"], 8, smi, tmp, which="pool")]
        de_runs = [render_end_to_end(de["fractal"], 8, smi, tmp, passes=True),
                   render_end_to_end(de["julia"], 8, smi, tmp, passes=True)]
        mesh_run = render_end_to_end(mesh["terrain_405"], 8, smi, tmp)
        query_run = drive_queries(mesh["terrain_405"], smi)
        march_run = drive_march(de["fractal"], smi)
        # textures, normal maps, ray-reading programs (the kProg
        # instantiations) and 129-1024 primitives (the wide kernels)
        tex_started = time.perf_counter()
        tex = texture_paths(os.path.join(tmp, "textures"))
        tex_worst = {name: check_kernels(name, tex[name]) for name in (
            "textures", "untextured", "textures_512", "textures_1k")}
        divergent = {k: (w["divergent"], w["nee_divergent"]) for k, w in tex_worst.items()
                     if w["divergent"] or w["nee_divergent"]}
        assert not divergent, f"the bounce or NEE kernel diverges from the plain version: {divergent}"
        for name in ("textures", "textures_512"):
            times.update(time_kernels(tex[name], smi, plain_reps=2))
        time_kernels(tex["textures_1k"], smi, plain_reps=1)  # printed: textures of a user's size
        time_kernels(tex["untextured"], smi, plain_reps=2)  # printed: the same geometry untextured
        tex_runs = [render_end_to_end(tex["textures"], 8, smi, tmp),
                    render_end_to_end(tex["textures"], 8, smi, tmp, which="one-shot"),
                    render_end_to_end(tex["textures_512"], 8, smi, tmp)]
        print(f"[phase] textures, normal maps and programs: {time.perf_counter() - tex_started:.1f} s")
        gate, gate_worst, gate_drawn, gate_runs = check_gate(os.path.join(tmp, "gate"), smi, tmp)
        drawn.update(gate_drawn)
        # the bidirectional renderer: its kernels against their plain
        # versions, a render through them against one through the plain
        # versions, then the CLI (each with the counts zeroed just before)
        bdpt_started = time.perf_counter()
        print(f"[phase] phases 3-5 of the simple renderer: {bdpt_started - phases_started:.1f} s")
        bdpt = bdpt_scene_paths(tmp, spp=2)
        bdpt_checked = {name: check_bdpt(name, bdpt[name]) for name in (
            "cornell_class", "flagship_bdpt", "terrain_405_bdpt", "terrain_de_24_bdpt")}
        times.update(time_bdpt(bdpt_checked["cornell_class"], smi))
        time_bdpt(bdpt_checked["flagship_bdpt"], smi)  # printed: a dense scene without DE shapes
        small = os.path.join(tmp, "cornell_64")
        os.makedirs(small)
        cornell_64 = write_cornell_scene(small, 64, 64, spp=2)
        bdpt_plain = compare_bdpt_plain(cornell_64, 2, smi)
        bdpt_runs = [render_bdpt(bdpt[name], 2, smi, tmp)[0] for name in (
            "cornell_class", "flagship_bdpt", "flagship_bdpt_24", "terrain_405_bdpt")]
        # the regen scheduler: its film against one-shot's, the kernels at
        # one of its wavefronts, then the CLI through it
        regen_checked, regen_runs = regen_bdpt_step(bdpt, cornell_64, smi, tmp)
        bdpt_runs += regen_runs
        tex_bdpt = {name: check_bdpt(name, tex[name]) for name in ("textures_bdpt", "untextured_bdpt")}
        _, tex_bdpt["textures_bdpt"]["worst"]["color_edges"] = check_color_edges(
            "textures_bdpt", tex["textures_bdpt"], *tex_bdpt["textures_bdpt"]["setup"][3:])
        times.update({k: v for k, v in time_bdpt(tex_bdpt["textures_bdpt"], smi).items()
                      if "prog" in k or "colors" in k})
        time_bdpt(tex_bdpt["untextured_bdpt"], smi)  # printed: the same geometry untextured
        tex_bdpt_run = render_bdpt(tex["textures_bdpt"], 2, smi, tmp)[0]
        gate_bdpt, gate_bdpt_runs = check_gate_bdpt(gate, smi, tmp)
        print(f"[phase] the bidirectional renderer (phase 6): "
              f"{time.perf_counter() - bdpt_started:.1f} s")
        # the photon renderer: the record fields and the gather against
        # their plain versions, the gather's time, then the CLI
        photon_started = time.perf_counter()
        photon = photon_scene_paths(os.path.join(tmp, "photon"))
        photon["flagship_photon_512"] = photon_bins_scene(photon["flagship_photon"], 512)
        edge_err = check_gather_edges(smi)
        photon_checked = {name: check_photon(name, p) for name, p in photon.items()}
        times.update(time_photon(photon_checked["flagship_photon"], smi))
        time_photon(photon_checked["textures_photon"], smi)  # printed: interpolation mode
        times["dense_bounce_kernel<record,prog> S+G"] = time_record_form(photon["textures_photon"], True, smi)
        photon_runs = [render_photon(photon[name], 1, smi, tmp)[0] for name in (
            "flagship_photon", "textures_photon", "flagship_photon_512")]
        print(f"[phase] the photon renderer (phase 7): {time.perf_counter() - photon_started:.1f} s")
        multi_runs = multi_device_step(paths["flagship"], bdpt["flagship_bdpt_deep"],
                                       photon["flagship_photon"], smi, tmp)
        wide_worst, wide_runs = wide_step(os.path.join(tmp, "wide"), smi)
        last_worst, last_runs, last_times = gate_last_step(os.path.join(tmp, "gate_last"), smi)
        times.update(last_times)

    def kernel(name, source, replaces, launches, err):
        ms, plain_ms, size, ops = times[name]
        by_bytes, by_ops = size / HBM_BYTES_PER_S * 1e3, ops / _fp32_rate() * 1e3
        return {
            "name": name, "route": "cuda", "source": f"pyrite_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations", "library_ms": None,
        }

    # launches of the main paths: the simple renderer's, then the
    # bidirectional renderer's (bdpt_runs), then those of the textures
    # scenes (tex_runs, tex_bdpt_run); phase 8's ranks (multi_runs) count
    # in dense_total and, for the kernels only BDPT and photon run, in
    # multi_total
    wide_simple = [wide_runs[k] for k in ("textures_s512", "textures_deep_s128", "flagship_s512")]
    last = list(last_runs.values())  # phase 10's renders, each kind of scene
    photon_runs = photon_runs + [wide_runs["textures_photon_512"]]
    bdpt_runs = bdpt_runs + [wide_runs["flagship_bdpt_s128"]]
    dense_total = lambda key: sum(run[key] for run in dense_runs + de_runs + gate_runs + multi_runs
                                  + wide_simple + last)
    multi_total = lambda *keys: sum(run[k] for run in multi_runs for k in keys)
    tex_total = lambda key: sum(run[key] for run in tex_runs + [tex_bdpt_run] + gate_runs
                                + photon_runs + wide_simple + last)
    tex_err = lambda w: max(w["bounce"], w["brightness"])
    photon_record = sum(run["dense_bounce_kernel<record,prog>"] for run in photon_runs)
    bdpt_total = lambda *keys: sum(run[k] for run in bdpt_runs + gate_bdpt_runs + photon_runs
                                   + last for k in keys)
    wide_total = lambda key: sum(run[key] for run in [mesh_run] + gate_runs)
    passes = ("de_march_pass", "de_shadow_pass", "de_query_pass")
    rendered = dense_runs + de_runs + [mesh_run] + gate_runs + wide_simple
    queried = queries.values()
    checked = list(worst.values()) + [gate_worst[k] for k in (
        "flagship_s32", "flagship_s24", "flagship_s64", "flagship_s17", "flagship_s33",
        "flagship_s110", "de_130", "de_520", "julia_s24")]
    checked_wide = [worst_wide] + [gate_worst[k] for k in (
        "sunlit_terrain_405", "materials_300", "terrain_24_s32")]
    bdpt_worst = [c["worst"] for c in list(bdpt_checked.values()) + list(gate_bdpt.values())]
    tex_bdpt_worst = tex_bdpt["textures_bdpt"]["worst"]
    kernels = [
        kernel("dense_bounce_kernel", "bounce.cu", "pyrite_tpu/kernels_dense.py:717",
               dense_total("dense_bounce_kernel"),
               max(max(max(w["bounce"], w["brightness"]) for w in checked), last_worst["dense"])),
        kernel("dense_nee_kernel", "bounce.cu", "pyrite_tpu/kernels_dense.py:909",
               dense_total("dense_nee_kernel") + bdpt_total("dense_nee_kernel"),
               max(max(w["nee"] for w in checked), last_worst["dense_nee"])),
        kernel("march_de_kernel", "march_de.cuh", "pyrite_tpu/kernels.py:907",
               march_run["march_de_kernel"] + sum(
                   run["de_march_pass"] + run["de_shadow_pass"] for run in de_runs)
               + bdpt_total(*passes),
               max(max(m["err"] for m in marched.values()), max(shadowed.values()),
                   last_worst["march"])),
        kernel("wide_closest_kernel", "wide_bvh.cu", "pyrite_tpu/kernels.py:541",
               query_run["wide_closest_kernel"], max(q["closest"] for q in queried)),
        kernel("wide_shadow_kernel", "wide_bvh.cu", "pyrite_tpu/kernels.py:593",
               query_run["wide_shadow_kernel"] + bdpt_total("wide_shadow_kernel"),
               max(q["shadow"] for q in queried)),
        kernel("wide_bounce_kernel", "bounce.cu", "pyrite_tpu/kernels.py:125",
               wide_total("wide_bounce_kernel"),
               max(max(w["bounce"], w["brightness"]) for w in checked_wide)),
        kernel("wide_nee_kernel", "bounce.cu", "pyrite_tpu/kernels.py:337",
               wide_total("wide_nee_kernel") + bdpt_total("wide_nee_kernel"),
               max(w["nee"] for w in checked_wide)),
        kernel("philox_draws_kernel", "draws.cu", "pyrite_tpu/tracer.py:1069",
               sum(run["philox_draws_kernel"] for run in rendered + bdpt_runs + gate_bdpt_runs
                   + photon_runs + multi_runs),
               max(max(drawn.values()), wide_worst["draws"])),
        # the bidirectional renderer's kernels port no TPU kernel (the JAX
        # package runs these steps in XLA); timed on cornell_class
        dict(kernel("dense_bounce_kernel<record>", "bounce.cu", None,
                    bdpt_total("dense_bounce_kernel<record>", "wide_bounce_kernel<record>")
                    + multi_total("dense_bounce_kernel<record>"),
                    max(max(max(w["record"], w["brightness"]) for w in bdpt_worst + [regen_checked]),
                        max(c["worst"]["record"] for c in photon_checked.values()),
                        gate_worst["flagship_s24_bdpt"]["record"], wide_worst["record"])),
             name="dense_bounce_kernel<record>, wide_bounce_kernel<record>",
             replaces="none: XLA, pyrite_tpu/tracer.py:1585 bounce_core's info"),
        dict(kernel("dense_lamp_kernel", "bounce.cu", None,
                    bdpt_total("dense_lamp_kernel", "wide_lamp_kernel") + multi_total("dense_lamp_kernel"),
                    max(max(w["lamp"] for w in bdpt_worst),
                        max(c["worst"]["lamp"] for c in photon_checked.values()))),
             name="dense_lamp_kernel, wide_lamp_kernel",
             replaces="none: XLA, pyrite_tpu/tracer.py:1953 lamp_bounce_step"),
        dict(kernel("dense_shadow_kernel", "bounce.cu", None,
                    bdpt_total("dense_shadow_kernel") + multi_total("dense_shadow_kernel"), 0.0),
             replaces="none: XLA, pyrite_tpu/tracer.py:432 intersect_shadow"),
        # the kProg instantiations: the textures scenes' programs per lane
        kernel("dense_bounce_kernel<prog>", "bounce.cu", "pyrite_tpu/kernels_dense.py:717",
               tex_total("dense_bounce_kernel<prog>"),
               max(max(tex_err(w) for w in (tex_worst["textures"], tex_worst["textures_1k"],
                                            gate_worst["textures_deep"])), wide_worst["prog"],
                   last_worst["prog"])),
        kernel("dense_nee_kernel<prog>", "bounce.cu", "pyrite_tpu/kernels_dense.py:909",
               tex_total("dense_nee_kernel<prog>"),
               max(max(w["nee"] for w in (tex_worst["textures"], tex_worst["textures_1k"],
                                          gate_worst["textures_deep"])), wide_worst["prog_nee"],
                   last_worst["prog_nee"])),
        kernel("wide_bounce_kernel<prog>", "bounce.cu", "pyrite_tpu/kernels.py:125",
               tex_total("wide_bounce_kernel<prog>"), tex_err(tex_worst["textures_512"])),
        kernel("wide_nee_kernel<prog>", "bounce.cu", "pyrite_tpu/kernels.py:337",
               tex_total("wide_nee_kernel<prog>"), tex_worst["textures_512"]["nee"]),
        dict(kernel("dense_bounce_kernel<record,prog>", "bounce.cu", None,
                    tex_total("dense_bounce_kernel<record,prog>") - photon_record,
                    max(tex_bdpt_worst["record"], tex_bdpt_worst["brightness"], last_worst["record"])),
             replaces="none: XLA, pyrite_tpu/tracer.py:1585 bounce_core's info"),
        # the kProg form at the photon renderer's S + G columns (textures_photon's
        # camera walk: 70, and 518 at 512 bins in phase 9), its launches there
        dict(kernel("dense_bounce_kernel<record,prog> S+G", "bounce.cu", None, photon_record,
                    max(photon_checked["textures_photon"]["worst"]["record"], wide_worst["record"])),
             replaces="none: XLA, pyrite_tpu/tracer.py:1585 bounce_core's info"),
        dict(kernel("dense_lamp_kernel<prog>", "bounce.cu", None,
                    tex_total("dense_lamp_kernel<prog>"), max(tex_bdpt_worst["lamp"], wide_worst["lamp"],
                                                              last_worst["lamp"])),
             replaces="none: XLA, pyrite_tpu/tracer.py:1953 lamp_bounce_step"),
        dict(kernel("program_colors_kernel", "bounce.cu", None, tex_total("program_colors_kernel"),
                    max(tex_bdpt_worst["colors"], tex_bdpt_worst["color_edges"], last_worst["colors"])),
             replaces="none: XLA, pyrite_tpu/renderers/bidirectional.py:73 _lamp_path_factors"),
        # the photon renderer's gather ports no TPU kernel either
        dict(kernel("photon_gather_kernel", "photon.cu", None,
                    sum(run["photon_gather_kernel"] for run in photon_runs + multi_runs),
                    max(max(c["worst"]["gather"] for c in photon_checked.values()), edge_err,
                        wide_worst["gather"])),
             replaces="none: XLA, pyrite_tpu/renderers/photon.py:310 _gather"),
        # phase 10's new form: the gather past its row form's bins
        dict(kernel("photon_gather_kernel<out_row>", "photon.cu", None,
                    sum(run["photon_gather_kernel<out_row>"] for run in last), last_worst["out_row"]),
             replaces="none: XLA, pyrite_tpu/renderers/photon.py:310 _gather"),
    ]
    assert all(k["launches"] > 0 for k in kernels), kernels
    print(f"[de-shadow] blocked shares {shadow}")
    print(f"[schedulers] regen and pool against one-shot, largest acc relative difference {same}")
    print(f"[bdpt] kernels against plain render, largest per-pixel wt and acc relative "
          f"differences (plain with the kernels' sampling, then as it is) and the shares of "
          f"pixels beyond 1e-5 and 1e-3 {bdpt_plain}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
