"""Keyed random draws: Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11), counter-based, so a render's draws
depend on its seed and on (pixel, sample, bounce, purpose) alone, not on how
samples are batched into wavefronts nor on the device.

Layout of one draw. The key is the render's seed as two 32-bit words (low,
high). The counter is four 32-bit words, (pixel index, global sample index,
bounce, purpose << 16 | block): the camera draws take bounce 0 and are told
apart from the first bounce's by their purpose; ``block`` is the index of a
4-word output group within the purpose, and word k of a purpose's draws per
lane is word k % 4 of block k // 4. Per lane:

  purpose    draws                  words
  CAMERA     [S + 5]                jitter 2, lens 2, wavelengths S, hero 1
  U_COMP     u_comp                 1
  U_SCATTER  u_scatter [3]          3
  LAMP       lamp_idx               1, as min(floor(u * lamps), lamps - 1)
  U_NEE      u_nee [ls, 4]          light sample j is block j
  U_EMIS     u_emis [ls]            light sample j is word j
  LAMP_START [6]                    a lamp path's start (bounce 0): lamp pick
                                    1, emitter uniforms 4, emissive
                                    component 1
  LAMP_BOUNCE [4]                   lamp bounce d (bounce word d): u_comp 1,
                                    u_scatter 3
  SPLAT      [K, 2]                 lamp slot k's lens uniforms are words
                                    0-1 of block k (bounce 0), k the slot's
                                    index in the uncompacted lamp path
  PHOTON_WL  [1]                    a photon's lamp-path wavelength (bounce 0)
  FRESH      [2 K + 1]              a camera vertex's fresh wavelengths at
                                    camera bounce b (bounce word b): K for its
                                    gathered pairs, then K + 1 for a vertex
                                    that gathers nothing (K = S)

The photon renderer (renderers/photon.py) keys sample i's draws by two
kinds of global sample. Its camera pass takes sample i (1 + P), P the
photon passes, as the camera draws above. Its photon pass p takes sample i
(1 + P) + 1 + p: the photon's index in the pixel word for PHOTON_WL,
LAMP_START and LAMP_BOUNCE, and the camera lane's pixel for FRESH. No
other draw of a render shares those counters, so the film depends on
(seed, sample, pass, photon or pixel) alone.

A uniform is (x >> 8) * 2^-24, exact in f32 on every device. Lanes take
their words in one of two ways. ``KeyedDraws`` (affine, the one-shot
wavefront): lane l of a wavefront of ``samples`` samples starting at sample
``sample0`` draws for pixel ``pixel0 + l % n_pix`` and sample ``sample0 + l
// n_pix``, every lane at the bounce the call names. ``LaneKeys``
(indexed, the regeneration and survivor-pool schedulers): int32 tensors
give each lane its pixel, its sample and, optionally, its bounce; fed the
affine indices they give the affine draws bit for bit.

``camera_uniforms``, ``bounce_draws``, ``lane_draws`` (a regeneration
iteration's camera draws, on a mask of lanes, and bounce draws in one
launch) and ``purpose_words`` (one purpose's words, the bidirectional
renderer's lamp and splat draws) compute the plain version for tensors on the CPU and launch
``philox_draws_kernel`` (csrc/draws.cu) on a CUDA device, one launch per
call; ``philox_plain`` is the plain version on any device. It replaces
the per-bounce jax.random draws of the JAX package
(pyrite_tpu/tracer.py draw_bounce_uniforms), which keys its draws per
(sample, bounce, purpose) with threefry; the bits differ, the layout of the
draws dict does not.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

(CAMERA, U_COMP, U_SCATTER, LAMP, U_NEE, U_EMIS, LAMP_START, LAMP_BOUNCE, SPLAT, PHOTON_WL,
 FRESH) = range(11)

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key schedule (Weyl) increments
_MASK = 0xFFFFFFFF
_ROUNDS = 10
INT_MAX = 2**31 - 1

# Each wrapper adds one here where it launches its kernel.
launches = {"philox_draws_kernel": 0}


@dataclass(frozen=True)
class KeyedDraws:
    """The draws of ``samples`` samples from sample ``sample0`` of a render
    keyed by ``seed``, over pixels from ``pixel0`` (a row window's first
    pixel)."""

    seed: int
    sample0: int = 0
    samples: int = 1
    pixel0: int = 0

    def key(self):
        return self.seed & _MASK, (self.seed >> 32) & _MASK

    def n_pix(self, n):
        """Pixels per sample of an ``n``-lane wavefront."""
        if n % self.samples:
            raise ValueError(f"{n} lanes do not split into {self.samples} samples")
        return n // self.samples


@dataclass(frozen=True)
class LaneKeys:
    """Draws keyed lane by lane under ``seed``: lane l draws for pixel
    ``pixel[l]`` and sample ``sample[l]``, at bounce ``depth[l]`` or, where
    ``depth`` is None, at the bounce the call names. The three are [n] int32
    tensors on the device that draws."""

    seed: int
    pixel: torch.Tensor
    sample: torch.Tensor
    depth: torch.Tensor | None = None

    def key(self):
        return self.seed & _MASK, (self.seed >> 32) & _MASK


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64
    tensor x of 32-bit words, every intermediate below 2^63: m is split into
    16-bit halves and the high half's product into 16-bit halves again."""
    a = x * (m & 0xFFFF)  # < 2^48
    b = x * (m >> 16)  # < 2^48
    t = a + ((b & 0xFFFF) << 16)  # < 2^49
    return (b >> 16) + (t >> 32), t & _MASK


def philox_plain(key, counters):
    """Philox4x32-10 of int64 tensors ``counters`` [..., 4] (32-bit words)
    under ``key`` (two ints): the four output words, int64 [..., 4]."""
    k0, k1 = key
    c0, c1, c2, c3 = counters.unbind(-1)
    for r in range(_ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def to_uniform(words):
    """(x >> 8) * 2^-24 in f32: 24 random bits, exact."""
    return (words >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _lanes(draws, n, bounce, device):
    """(pixel, sample, bounce) int64 words of each of ``n`` lanes."""
    if isinstance(draws, LaneKeys):
        word = lambda t: t.to(device=device, dtype=torch.int64) & _MASK
        depth = (torch.full((n,), bounce & _MASK, dtype=torch.int64, device=device)
                 if draws.depth is None else word(draws.depth))
        return word(draws.pixel), word(draws.sample), depth
    n_pix = draws.n_pix(n)
    lane = torch.arange(n, dtype=torch.int64, device=device)
    return ((draws.pixel0 + lane % n_pix) & _MASK, (draws.sample0 + lane // n_pix) & _MASK,
            torch.full((n,), bounce & _MASK, dtype=torch.int64, device=device))


def purpose_uniforms(draws, n, bounce, purpose, width, device, take=4):
    """The plain version of one purpose's draws: [n, width] f32 uniforms
    for each lane at ``bounce`` (a LaneKeys' own depth where it has one),
    uniform j from word j % take of block j // take (take = 4: words 0 ..
    width - 1)."""
    pixel, sample, depth = _lanes(draws, n, bounce, device)
    blocks = -(-width // take)
    ctr = torch.stack([
        pixel[:, None].expand(n, blocks),
        sample[:, None].expand(n, blocks),
        depth[:, None].expand(n, blocks),
        (purpose << 16) + torch.arange(blocks, dtype=torch.int64, device=device)[None, :].expand(n, blocks),
    ], dim=-1)
    words = philox_plain(draws.key(), ctr)[..., :take].reshape(n, blocks * take)[:, :width]
    return to_uniform(words)


def lamp_index(u, num_lamps):
    """min(floor(u * lamps), lamps - 1) as int32."""
    return torch.clamp((u * float(num_lamps)).to(torch.int32), max=num_lamps - 1)


def camera_plain(draws, n, s, device):
    """The camera draws (bounce 0) of every lane, whatever a LaneKeys'
    depth."""
    if isinstance(draws, LaneKeys):
        draws = LaneKeys(draws.seed, draws.pixel, draws.sample)
    return purpose_uniforms(draws, n, 0, CAMERA, s + 5, device)


def bounce_plain(draws, n, bounce, light_samples, num_lamps, device):
    """The plain version of bounce_draws."""
    u = lambda purpose, width: purpose_uniforms(draws, n, bounce, purpose, width, device)
    out = {"u_comp": u(U_COMP, 1)[:, 0].contiguous(), "u_scatter": u(U_SCATTER, 3)}
    if num_lamps > 0 and light_samples > 0:
        out["lamp_idx"] = lamp_index(u(LAMP, 1)[:, 0], num_lamps).contiguous()
        out["u_nee"] = u(U_NEE, 4 * light_samples).view(n, light_samples, 4).transpose(0, 1).contiguous()
        out["u_emis"] = u(U_EMIS, light_samples).t().contiguous()
    return out


def _layout(n, light_samples, num_lamps):
    """Offsets of a bounce's draws in the kernel's one f32 buffer: with
    lamps u_nee [ls, n, 4] first (16-byte aligned for the kernel's vector
    stores), then u_comp [n], u_scatter [n, 3] and with lamps lamp_idx [n]
    (int32 bits) and u_emis [ls, n]. Returns (total floats, {name: (offset,
    shape)})."""
    lamps = num_lamps > 0 and light_samples > 0
    parts = {"u_nee": (light_samples, n, 4)} if lamps else {}
    parts.update(u_comp=(n,), u_scatter=(n, 3))
    if lamps:
        parts.update(lamp_idx=(n,), u_emis=(light_samples, n))
    out, off = {}, 0
    for name, shape in parts.items():
        out[name] = (off, shape)
        off += math.prod(shape)
    return off, out


def _check_lanes(n):
    if n > INT_MAX:
        raise ValueError(f"{n} lanes: philox_draws_kernel takes at most INT_MAX = {INT_MAX}")


def _index(name, t, n, dev):
    """The address of an indexed-mode [n] tensor, checked."""
    from .kernels_dense import _check

    return _check(name, t, torch.uint8 if name == "camera_mask" else torch.int32, (n,), dev)


def _launch(draws, n, dev, cam_out=None, out=None, bounce=0, s_cam=0, light_samples=0,
            num_lamps=0, camera_mask=None, words_out=None, purpose=0, take=4):
    """One launch of philox_draws_kernel writing the camera draws [n, s_cam
    + 5] into ``cam_out`` and a bounce's draws in _layout into ``out`` (each
    where given), or one purpose's words [n, width] into ``words_out``
    (purpose_words); a LaneKeys launches the indexed mode, where
    ``camera_mask`` (bool [n]) picks the lanes that take camera draws."""
    from . import _build

    k0, k1 = draws.key()
    if isinstance(draws, LaneKeys):
        affine = (1, 0, 0)
        index = [_index("pixel", draws.pixel, n, dev), _index("sample", draws.sample, n, dev),
                 0 if draws.depth is None else _index("depth", draws.depth, n, dev),
                 0 if camera_mask is None else _index("camera_mask", camera_mask.view(torch.uint8), n, dev)]
    else:
        affine = (draws.n_pix(n), draws.pixel0 & _MASK, draws.sample0 & _MASK)
        index = [0, 0, 0, 0]
    rc = _build.load().pyrite_philox_draws(
        k0, k1, n, *affine, bounce & _MASK, s_cam, light_samples, num_lamps,
        0 if cam_out is None else cam_out.data_ptr(), 0 if out is None else out.data_ptr(), *index,
        0 if words_out is None else words_out.data_ptr(), purpose,
        0 if words_out is None else words_out.shape[1], take,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"philox_draws_kernel launch failed: cudaError {rc}")
    launches["philox_draws_kernel"] += 1


def _device(device):
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the keyed draws run on CPU or CUDA tensors, not {dev}")
    if dev.type == "cuda" and dev.index is None:  # as the tensors made on it report it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# csrc/draws.cu CAM_STAGED: the most words of a lane's camera row a block
# stages (past it, each thread stores the words of a Philox block straight)
CAM_STAGED = 92


def draws_smem_bytes(s):
    """philox_draws_kernel's dynamic shared memory with camera draws of S
    columns (csrc/draws.cu stage_bytes): a block's [128, S + 5] camera
    rows up to CAM_STAGED words, and at least its [128, 3] u_scatter;
    1,536 bytes past S = 87."""
    w = s + 5 if s + 5 <= CAM_STAGED else 3
    return 4 * 128 * max(w, 3)


def _camera_buffer(n, s, dev):
    if s < 1:
        raise ValueError(f"{s} spectrum samples; the camera draws take at least 1")
    return torch.empty((n, s + 5), dtype=torch.float32, device=dev)


def _bounce_buffer(n, light_samples, num_lamps, dev):
    """(one f32 buffer for a bounce's draws, the draws dict of its views)."""
    total, layout = _layout(n, light_samples, num_lamps)
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    out = {}
    for name, (off, shape) in layout.items():
        view = buf[off : off + math.prod(shape)].view(shape)
        out[name] = view.view(torch.int32) if name == "lamp_idx" else view
    return buf, out


def camera_uniforms(draws, n, s, device):
    """The camera draws of ``n`` lanes, [n, s + 5] f32 (renderers.simple
    camera_rays' layout: jitter 2, lens 2, wavelengths s, hero 1), at bounce
    0 whatever a LaneKeys' depth."""
    dev = _device(device)
    if dev.type == "cpu":
        return camera_plain(draws, n, s, dev)
    _check_lanes(n)
    u = _camera_buffer(n, s, dev)
    _launch(draws, n, dev, cam_out=u, s_cam=s)
    return u


def bounce_draws(draws, n, bounce, light_samples, num_lamps, device):
    """All of one bounce's draws for ``n`` lanes, in the layout of
    tracer.draw_bounce_uniforms: u_comp [n], u_scatter [n, 3] and, with
    lamps and light samples, lamp_idx [n] int32, u_nee [ls, n, 4], u_emis
    [ls, n]; at ``bounce``, or a LaneKeys' own depth. On a CUDA device one
    launch writes them all into one buffer, of which the tensors are
    views."""
    dev = _device(device)
    if dev.type == "cpu":
        return bounce_plain(draws, n, bounce, light_samples, num_lamps, dev)
    _check_lanes(n)
    buf, out = _bounce_buffer(n, light_samples, num_lamps, dev)
    _launch(draws, n, dev, out=buf, bounce=bounce, light_samples=light_samples, num_lamps=num_lamps)
    return out


def lane_draws_plain(keys: LaneKeys, s, light_samples, num_lamps, camera_mask, device):
    """The plain version of lane_draws."""
    n = keys.pixel.shape[0]
    cam = camera_plain(keys, n, s, device)
    cam = torch.where(camera_mask.to(device)[:, None], cam, 0.0)
    return cam, bounce_plain(keys, n, 0, light_samples, num_lamps, device)


def lane_draws(keys: LaneKeys, s, light_samples, num_lamps, camera_mask, device):
    """A regeneration iteration's draws in one launch: (the camera draws [n,
    s + 5] of the lanes ``camera_mask`` (bool [n]) picks, zeros on the
    others; the bounce draws of every lane at its own depth, as
    bounce_draws)."""
    dev = _device(device)
    if keys.depth is None:
        raise ValueError("lane_draws draws each lane at its own depth: LaneKeys.depth is None")
    n = keys.pixel.shape[0]
    if dev.type == "cpu":
        return lane_draws_plain(keys, s, light_samples, num_lamps, camera_mask, dev)
    _check_lanes(n)
    cam = _camera_buffer(n, s, dev)
    buf, out = _bounce_buffer(n, light_samples, num_lamps, dev)
    _launch(keys, n, dev, cam_out=cam, out=buf, s_cam=s, light_samples=light_samples,
            num_lamps=num_lamps, camera_mask=camera_mask)
    return cam, out


def purpose_words(draws, n, bounce, purpose, width, device, take=4):
    """One purpose's uniforms for ``n`` lanes at ``bounce`` (a LaneKeys'
    own depth where it has one), [n, width] f32, uniform j from word j %
    take of block j // take (purpose_uniforms); one launch on a CUDA
    device. The bidirectional renderer's draws: LAMP_START (width 6),
    LAMP_BOUNCE (width 4) at the lamp depth, SPLAT (width 2 K, take 2)."""
    dev = _device(device)
    if dev.type == "cpu":
        return purpose_uniforms(draws, n, bounce, purpose, width, dev, take)
    _check_lanes(n)
    if not 1 <= take <= 4 or width < 1:
        raise ValueError(f"purpose_words takes 1 to 4 words a block and width >= 1, not {take}, {width}")
    if -(-width // take) > 0xFFFF:
        raise ValueError(f"{width} words of {take} a block: more blocks than a purpose counts (65,535)")
    out = torch.empty((n, width), dtype=torch.float32, device=dev)
    _launch(draws, n, dev, bounce=bounce, words_out=out, purpose=purpose, take=take)
    return out


def lamp_start_draws(draws, n, num_lamps, device):
    """A lamp path's start draws (LAMP_START): {"words": [n, 6], "lamp_idx"
    [n] int32 (the uniform lamp pick), "u_lamp" [n, 4] (the emitter's point
    and direction), "u_emis" [n] (the emissive component)}, the tensors
    views of "words" but lamp_idx."""
    w = purpose_words(draws, n, 0, LAMP_START, 6, device)
    return {"words": w, "lamp_idx": lamp_index(w[:, 0], max(num_lamps, 1)),
            "u_lamp": w[:, 1:5], "u_emis": w[:, 5]}


def lamp_bounce_draws(draws, n, depth, device):
    """Lamp bounce ``depth``'s draws (LAMP_BOUNCE): {"words": [n, 4],
    "u_comp" [n], "u_scatter" [n, 3]}, views of "words"."""
    w = purpose_words(draws, n, depth, LAMP_BOUNCE, 4, device)
    return {"words": w, "u_comp": w[:, 0], "u_scatter": w[:, 1:4]}


def splat_draws(draws, n, slots, device):
    """The light-tracing splats' lens uniforms (SPLAT), [n, slots, 2]: slot
    k's from block k, whatever slots a later compaction keeps."""
    return purpose_words(draws, n, 0, SPLAT, 2 * slots, device, take=2).view(n, slots, 2)


def _span_uniform(u, span):
    """lo + u (hi - lo): uniforms over the wavelength span."""
    lo, hi = span
    return lo + u * (hi - lo)


def photon_wavelengths(draws, n, span, device):
    """Each of ``n`` photons' lamp-path wavelength (PHOTON_WL), [n, 1],
    uniform over ``span`` (photon_mapping.rs:199)."""
    return _span_uniform(purpose_words(draws, n, 0, PHOTON_WL, 1, device), span)


def fresh_wavelengths(draws, n, bounce, k, span, device):
    """Camera bounce ``bounce``'s fresh wavelengths (FRESH) of ``n`` lanes,
    uniform over ``span``: (for the gathered pairs [n, k], for a vertex
    that gathers nothing [n, k + 1])."""
    lam = _span_uniform(purpose_words(draws, n, bounce, FRESH, 2 * k + 1, device), span)
    return lam[:, :k], lam[:, k:]
