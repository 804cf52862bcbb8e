"""The port's keyed draws (pyrite_tpu_torch/rng.py, the plain version of
csrc/draws.cu's philox_draws_kernel) and the entry points around them:

- Philox4x32-10 against its published known-answer vectors and a scalar
  Python Philox written here from the paper's round function;
- a render's image depends on its seed alone: two samples of the flagship
  scene rendered as one wavefront of two samples and as two of one are
  bit-equal;
- each purpose's uniforms pass a chi-square test of uniformity;
- the march passes refuse more rays per DE shape than an int indexes;
- build_scene and the convert helpers take the card unless told
  device="cpu", and raise without one.

The JAX package keys its draws with threefry, so no test here compares bits
with it; tests/test_torch_slice.py and tests/test_torch_kernels_dense.py feed
both packages the same draws."""

import types

import numpy as np
import pytest
import scipy.stats
import torch

import chip_smoke
import pyrite_tpu_torch.tracer as TT
from pyrite_tpu_torch import convert, kernels, kernels_dense, rng
from pyrite_tpu_torch.project import load_project
from pyrite_tpu_torch.renderers import simple
from pyrite_tpu_torch.scene import build_scene

torch.set_num_threads(2)

MASK = 0xFFFFFFFF


def scalar_philox(counter, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11, Figure 2)."""
    c, (k0, k1) = list(counter), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & MASK, p1 & MASK, ((p0 >> 32) ^ c[3] ^ k1) & MASK, p0 & MASK]
    return c


KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, want", KNOWN, ids=["zero", "pi"])
def test_philox_known_answers(counter, key, want):
    got = rng.philox_plain(key, torch.tensor([counter], dtype=torch.int64))[0].tolist()
    assert got == list(want)
    assert scalar_philox(counter, key) == list(want)


def test_philox_matches_scalar_on_random_counters():
    """Words near 2^32 on every input, where a signed 64-bit product of a
    multiplier and a word would overflow."""
    r = np.random.default_rng(0)
    counters = r.integers(0, 2**32, size=(256, 4), dtype=np.uint64).astype(np.int64)
    counters[:8] = MASK
    for key in ((0, 0), (MASK, MASK), (12345, 678)):
        got = rng.philox_plain(key, torch.as_tensor(counters)).tolist()
        assert got == [scalar_philox(c, key) for c in counters.tolist()]


def test_layout_of_keys():
    """The counter of each draw: lane l of a wavefront of two samples from
    sample 3 draws for (pixel l % n_pix, sample 3 + l // n_pix), block k of
    a purpose is word group k, and the uniform is (x >> 8) * 2^-24."""
    n_pix, seed = 40, (7 << 32) + 5
    keyed = rng.KeyedDraws(seed, sample0=3, samples=2, pixel0=100)
    draws = rng.bounce_draws(keyed, 2 * n_pix, 4, 3, 5, "cpu")
    assert {k: tuple(v.shape) for k, v in draws.items()} == {
        "u_comp": (80,), "u_scatter": (80, 3), "lamp_idx": (80,), "u_nee": (3, 80, 4),
        "u_emis": (3, 80)}
    lane, j = 57, 2
    pixel, sample = 100 + lane % n_pix, 3 + lane // n_pix
    words = lambda purpose, block: scalar_philox((pixel, sample, 4, (purpose << 16) | block), (5, 7))
    u = lambda x: (x >> 8) / 2.0**24
    assert draws["u_comp"][lane].item() == u(words(rng.U_COMP, 0)[0])
    assert draws["u_scatter"][lane].tolist() == [u(x) for x in words(rng.U_SCATTER, 0)[:3]]
    assert draws["u_nee"][j, lane].tolist() == [u(x) for x in words(rng.U_NEE, j)]
    assert draws["u_emis"][j, lane].item() == u(words(rng.U_EMIS, 0)[j])
    lamp = np.float32(u(words(rng.LAMP, 0)[0])) * np.float32(5.0)
    assert draws["lamp_idx"][lane].item() == min(int(lamp), 4)
    camera = rng.camera_uniforms(keyed, 2 * n_pix, 6, "cpu")
    cam = lambda block: scalar_philox((pixel, sample, 0, (rng.CAMERA << 16) | block), (5, 7))
    assert camera[lane].tolist() == [u(x) for x in cam(0) + cam(1) + cam(2)[:3]]
    # the second sample's lanes are the draws of a wavefront of that sample alone
    alone = rng.bounce_draws(rng.KeyedDraws(seed, 4, 1, 100), n_pix, 4, 3, 5, "cpu")
    for k, v in alone.items():
        lanes = 1 if k in ("u_nee", "u_emis") else 0
        assert torch.equal(draws[k].narrow(lanes, n_pix, n_pix), v), k


def test_kernel_buffer_layout():
    """The views bounce_draws takes of the kernel's one buffer have the
    plain dict's shapes, u_nee first and 16-byte aligned, no overlap."""
    n, ls = 37, 3
    total, layout = rng._layout(n, ls, 2)
    plain = rng.bounce_plain(rng.KeyedDraws(1), n, 0, ls, 2, "cpu")
    assert set(layout) == set(plain) and layout["u_nee"][0] == 0
    spans = sorted((off, off + int(np.prod(shape))) for off, shape in layout.values())
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for k, (_, shape) in layout.items():
        assert tuple(plain[k].shape) == shape
    assert set(rng._layout(n, ls, 0)[1]) == {"u_comp", "u_scatter"}


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("rng"))
    path = chip_smoke.scene_paths(directory, width=32, height=16, spectrum_samples=6, bounces=8)[
        "flagship"]
    project_data = load_project(path)
    return project_data, build_scene(project_data, device="cpu")


def test_render_is_the_same_in_any_batch(flagship, monkeypatch):
    """Two samples of the flagship scene, one wavefront of two samples
    against two wavefronts of one: the film is bit-equal (each lane draws by
    its pixel and sample; the film exposes them in sample order)."""
    project_data, scene = flagship
    monkeypatch.setattr(simple, "regen_enabled", lambda: False)  # the one-shot wavefront
    films = []
    for batch in (2, 1):
        monkeypatch.setattr(simple, "pick_sample_batch", lambda film, texture_bytes=0, lane_bytes=0, b=batch: b)
        _, acc, wt = simple.render(project_data, scene, seed=11, max_samples=2)
        films.append((acc, wt))
    (acc2, wt2), (acc1, wt1) = films
    assert float(acc1.sum()) > 0
    assert torch.equal(acc2, acc1) and torch.equal(wt2, wt1)
    # and a seed changes it
    _, acc, _ = simple.render(project_data, scene, seed=12, max_samples=2)
    assert not torch.equal(acc, acc1)


def _chi2_p(u, bins=16):
    counts = np.bincount(np.minimum((u * bins).astype(np.int64), bins - 1), minlength=bins)
    return scipy.stats.chisquare(counts).pvalue


def test_uniforms_pass_chi_square():
    """Every purpose's words, over a render step's lanes: 16-bin
    chi-square p above 1e-4 per column, the lamp index uniform over the
    lamps, and the purposes mutually uncorrelated."""
    n, ls = 32 * 16 * 4, 2
    keyed = rng.KeyedDraws(3, sample0=8, samples=4)
    draws = rng.bounce_draws(keyed, n, 1, ls, 3, "cpu")
    columns = {"camera": rng.camera_uniforms(keyed, n, 6, "cpu"), "u_comp": draws["u_comp"][:, None],
               "u_scatter": draws["u_scatter"], "u_nee": draws["u_nee"].permute(1, 0, 2).reshape(n, -1),
               "u_emis": draws["u_emis"].t()}
    for name, u in columns.items():
        u = u.numpy()
        assert ((u >= 0.0) & (u < 1.0)).all(), name
        for c in range(u.shape[1]):
            assert _chi2_p(u[:, c]) > 1e-4, (name, c)
    counts = np.bincount(draws["lamp_idx"].numpy(), minlength=3)
    assert counts.size == 3 and scipy.stats.chisquare(counts).pvalue > 1e-4
    every = np.concatenate([u.numpy() for u in columns.values()], axis=1)
    corr = np.corrcoef(every.T)
    assert np.abs(corr - np.eye(corr.shape[0])).max() < 5.0 / np.sqrt(n)


def test_march_passes_refuse_more_rays_than_an_int():
    """The march passes' items and work counter are 64-bit, a ray index
    within a shape an int: more rays than INT_MAX per DE shape raise,
    naming the limit, before anything is allocated or launched."""
    scene = types.SimpleNamespace(de_shapes=[None])
    cfg = TT.TraceConfig(bounces=1, light_samples=2**20, spectrum_samples=1)
    huge = torch.zeros((1, 3)).expand(2**31, 3)
    with pytest.raises(ValueError, match="INT_MAX = 2147483647"):
        kernels_dense.march_pass(scene, cfg, {"origin": huge, "direction": huge, "alive": None})
    lanes = torch.zeros((4096, 3))
    with pytest.raises(ValueError, match="INT_MAX"):
        kernels_dense.shadow_pass(scene, cfg, {"origin": lanes}, {}, {})
    with pytest.raises(ValueError, match="INT_MAX"):
        kernels.march_de(None, huge, huge, None, None, None, 200)
    kernels_dense.check_rays(2**31 - 1, "INT_MAX rays")


def test_entry_points_take_the_card_unless_told(flagship, monkeypatch):
    """build_scene and the convert helpers default to CUDA: without a CUDA
    device they raise and say to pass device="cpu"; with it they work."""
    project_data, scene = flagship
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        build_scene(project_data)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        convert.film_from_numpy(np.zeros((2, 2, 4), np.float32), np.zeros((2, 2, 4), np.float32))
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        convert.draws_from_numpy({"u_comp": np.zeros(4, np.float32)})
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        convert.scene_arrays_from_numpy({"x": np.zeros(4, np.float32)})
    assert build_scene(project_data, device="cpu").device == torch.device("cpu")
    back = convert.draws_from_numpy({"u_comp": np.ones(4, np.float32)}, "cpu")
    assert back["u_comp"].device.type == "cpu"
    assert scene.device.type == "cpu"
