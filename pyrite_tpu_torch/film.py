"""Film: spectral accumulation buffer + image development (PyTorch port of
pyrite_tpu.film).

The film is an accumulator pair (acc, weight) of shape [H, W, BINS] on the
film's device. Accumulation is deterministic: a lane's S wavelengths may land
in one bin, so a single scatter-add over all of them would sum colliding
updates in atomic order on CUDA. Each of the S spectral columns is scattered
on its own instead, one index per lane row, which never collides.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from . import spectra as spectra_mod


@dataclass(frozen=True)
class Film:
    width: int
    height: int
    bins: int
    span: tuple

    # --- buffers -------------------------------------------------------------
    def new_buffers(self, device):
        shape = (self.height, self.width, self.bins)
        return (
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
        )

    # --- aspect-ratio view <-> pixel mapping (film.rs:203-252) ----------------
    @property
    def _size(self) -> float:
        return float(max(self.width, self.height))

    @property
    def _ratio(self) -> float:
        return min(self.width, self.height) / max(self.width, self.height)

    def view_to_pixel(self, positions):
        """[.., 2] view coords -> (px, py, valid)."""
        x = positions[..., 0]
        y = positions[..., 1]
        if self.width >= self.height:
            valid = torch.abs(y) <= self._ratio
            fx = x + 1.0
            fy = y + self._ratio
        else:
            valid = torch.abs(x) <= self._ratio
            fx = x + self._ratio
            fy = y + 1.0
        px = torch.floor(self._size * fx * 0.5).to(torch.int32)
        py = torch.floor(self._size * fy * 0.5).to(torch.int32)
        valid &= (px >= 0) & (px < self.width) & (py >= 0) & (py < self.height)
        return px, py, valid

    def pixel_to_view(self, px, py):
        """Pixel coords (+ fractional jitter) -> view coords [.., 2].

        Matches Camera::to_view_area (cameras.rs:57-68): view x in [-1, 1]
        along the longer image axis."""
        max_dim = self._size
        x = (px - self.width * 0.5) / (max_dim * 0.5)
        y = (py - self.height * 0.5) / (max_dim * 0.5)
        return torch.stack([x, y], dim=-1)

    # --- wavelengths ----------------------------------------------------------
    def sample_wavelengths(self, u):
        """Stratified wavelengths from uniforms ``u`` [..., S] (film.rs:68-83)."""
        count = u.shape[-1]
        lo, hi = self.span
        step = (hi - lo) / count
        offsets = torch.arange(count, dtype=torch.float32, device=u.device) * step
        return lo + offsets + u * step

    def wavelength_to_bin(self, wavelength):
        lo, hi = self.span
        idx = ((wavelength - lo) * (self.bins / (hi - lo))).to(torch.int32)
        return torch.clamp(idx, 0, self.bins - 1)

    # --- exposure ----------------------------------------------------------------
    def expose(self, acc, wt, positions, wavelengths, brightness, weights, mask):
        """Accumulate a batch of spectral samples at their view positions
        (pyrite_tpu.film.Film.expose): positions [N, 2] view coords;
        wavelengths / brightness / weights / mask [N, S]. Samples whose
        position falls outside the film are dropped. Updates ``acc`` and
        ``wt`` in place and returns them."""
        px, py, valid = self.view_to_pixel(positions)
        return expose_pixels(self, acc, wt, py * self.width + px, valid, wavelengths, brightness,
                             weights, mask)

    # --- development -----------------------------------------------------------
    def develop(self, acc, wt):
        """acc/weight per bin -> [H, W, BINS] mean spectra."""
        return torch.where(wt > 0.0, acc / torch.where(wt > 0.0, wt, 1.0), 0.0)

    def to_srgb(self, acc, wt, step_size=2.0, sample_fn=None):
        bins = self.develop(acc, wt)
        return spectra_mod.develop_to_srgb(bins, self.span, step_size, sample_fn)

    def to_image(self, acc, wt, step_size=2.0, sample_fn=None):
        """Returns an [H, W, 3] uint8 numpy image."""
        out = self.to_srgb(acc, wt, step_size, sample_fn).cpu().numpy()
        return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)


def save_png(path: str, image: np.ndarray):
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG with the standard
    library alone (zlib + struct)."""
    image = np.ascontiguousarray(image, np.uint8)
    height, width, channels = image.shape
    if channels != 3:
        raise ValueError(f"save_png takes [H, W, 3] images, got {image.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    # every scanline starts with filter type 0 (None)
    raw = np.concatenate(
        [np.zeros((height, 1), np.uint8), image.reshape(height, width * 3)], axis=1
    )
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", header))
        fh.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(chunk(b"IEND", b""))


def bin_lane_sums(film: Film, wavelengths, v, w):
    """Per-lane wavelength->bin binning: ([N, bins] value sums, [N, bins]
    weight sums) from [N, S] per-wavelength values/weights (add_lane_bins
    into zeros: the JAX twin's unrolled one-hot sum, in the same order)."""
    n = v.shape[0]
    acc = torch.zeros((n, film.bins), dtype=v.dtype, device=v.device)
    wt = torch.zeros((n, film.bins), dtype=w.dtype, device=w.device)
    return add_lane_bins(film, acc, wt, wavelengths, v, w)


def expose_pixels(film: Film, acc, wt, pixel, valid, wavelengths, brightness, weights, mask):
    """Accumulate a batch of spectral samples at their flat pixel indices
    ``pixel`` [N] (row-major), where ``valid`` [N]: the scatter behind
    Film.expose, which the survivor pool calls with the pixel each of its
    lanes carries. Lanes may share a pixel, so on CUDA the adds into one bin
    land in atomic order (acc to float rounding; wt, sums of ones, exactly).
    Updates ``acc`` and ``wt`` in place and returns them."""
    ok = mask & valid[:, None]
    index = (pixel.long()[:, None] * film.bins + film.wavelength_to_bin(wavelengths).long())[ok]
    acc.view(-1).index_add_(0, index, (brightness * weights)[ok])
    wt.view(-1).index_add_(0, index, weights[ok])
    return acc, wt


def add_lane_bins(film: Film, acc_l, wt_l, wavelengths, v, w):
    """bin_lane_sums added into per-lane buffers ``acc_l`` / ``wt_l`` [N,
    bins] in place: one scatter per spectral column, each writing one bin
    per lane row, in column order (deterministic on every device)."""
    bins = film.wavelength_to_bin(wavelengths).long()
    for j in range(v.shape[1]):
        acc_l.scatter_add_(1, bins[:, j : j + 1], v[:, j : j + 1])
        wt_l.scatter_add_(1, bins[:, j : j + 1], w[:, j : j + 1])
    return acc_l, wt_l


def expose_sums(film: Film, acc, wt, positions, wavelengths, value_sums, weight_sums, mask):
    """Raw-sum exposure (pyrite_tpu.film.expose_sums): callers that
    aggregate many samples per lane (the bidirectional renderer's
    connections, len_cam x len_lamp samples at one pixel) add
    already-weighted value sums [N, S] and weight sums [N, S] at each
    lane's view position [N, 2]. Entries outside the film or off ``mask``
    [N, S] add zeros (to a pixel clamped into the film), so the scatter
    needs no host sync. One scatter per spectral column, as
    add_lane_bins: a lane's columns may share a bin, and the adds of one
    column land in distinct pixels but where two lanes share one. Updates
    ``acc`` and ``wt`` in place and returns them."""
    px, py, valid = film.view_to_pixel(positions)
    ok = mask & valid[:, None]
    pixel = py.long().clamp(0, film.height - 1) * film.width + px.long().clamp(0, film.width - 1)
    index = pixel[:, None] * film.bins + film.wavelength_to_bin(wavelengths).long()
    for j in range(value_sums.shape[1]):
        acc.view(-1).index_add_(0, index[:, j], torch.where(ok[:, j], value_sums[:, j], 0.0))
        wt.view(-1).index_add_(0, index[:, j], torch.where(ok[:, j], weight_sums[:, j], 0.0))
    return acc, wt


def expose_lanes(film: Film, acc, wt, row0, wavelengths, brightness, weights, mask):
    """Exposure for wavefront lanes that map 1:1 onto film pixels in
    row-major order starting at row ``row0`` (one jittered sample per pixel
    per step). Updates ``acc`` and ``wt`` in place (the film is the largest
    buffer a render holds) and returns them."""
    n = brightness.shape[0]
    v = torch.where(mask, brightness * weights, 0.0)
    w = torch.where(mask, weights, 0.0)
    acc_delta, wt_delta = bin_lane_sums(film, wavelengths, v, w)
    start = row0 * film.width
    acc.view(film.height * film.width, film.bins)[start : start + n] += acc_delta
    wt.view(film.height * film.width, film.bins)[start : start + n] += wt_delta
    return acc, wt
