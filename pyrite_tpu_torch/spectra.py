"""Spectral data types and colorimetry (PyTorch port of pyrite_tpu.spectra).

Everything radiometric is carried per wavelength (nm). Sampled spectra keep
their tables as host numpy arrays and move them to the device of the
wavelengths they are sampled at, once per device. The constants and the
development math follow pyrite_tpu/spectra.py line for line, including the
trapezoid integration with the XYZ scale factor 3.444.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .geometry import dot, power

DEFAULT_SPECTRUM_SPAN = (380.0, 780.0)

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "colorimetry.npz")


@lru_cache(maxsize=1)
def _data():
    with np.load(_DATA_PATH) as d:
        return {k: d[k] for k in d.files}


def _on(cache: dict, name: str, array: np.ndarray, device) -> torch.Tensor:
    """``array`` as a float32 tensor on ``device``, copied there once."""
    key = (name, str(device))
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(array, np.float32), device=device)
    return cache[key]


@dataclass(frozen=True)
class ArraySpectrum:
    """Uniform-grid sampled spectrum. Clamps to endpoints outside [min, max].

    ``values`` may be [N] (scalar spectrum) or [N, C] (e.g. the RGB basis).
    """

    min: float
    max: float
    values: np.ndarray
    _device_values: dict = field(default_factory=dict, compare=False, repr=False)

    def sample(self, wavelength: torch.Tensor) -> torch.Tensor:
        """Evaluate at ``wavelength``; returns its shape plus a trailing
        channel dim when the values are multi-channel."""
        values = _on(self._device_values, "values", self.values, wavelength.device)
        n = values.shape[0]
        normalized = (wavelength - self.min) / (self.max - self.min)
        float_index = torch.clamp(normalized * (n - 1), 0.0, n - 1.0)
        lo = torch.clamp(torch.floor(float_index).long(), 0, n - 2)
        frac = float_index - lo.to(float_index.dtype)
        a = values[lo]
        b = values[lo + 1]
        if values.ndim > 1:
            frac = frac[..., None]
        return a * (1.0 - frac) + b * frac


@dataclass(frozen=True)
class CurveSpectrum:
    """Piecewise-linear spectrum over (x, y) points; 0 outside (x[0], x[-1]),
    the endpoints included, like the reference's Interpolated::get."""

    xs: np.ndarray
    ys: np.ndarray
    _device_values: dict = field(default_factory=dict, compare=False, repr=False)

    def sample(self, wavelength: torch.Tensor) -> torch.Tensor:
        xs = _on(self._device_values, "xs", self.xs, wavelength.device)
        ys = _on(self._device_values, "ys", self.ys, wavelength.device)
        inside = (wavelength > xs[0]) & (wavelength < xs[-1])
        if xs.shape[0] < 2:
            return torch.zeros_like(wavelength)
        i = torch.clamp(torch.searchsorted(xs, wavelength.contiguous(), right=True), 1, xs.shape[0] - 1)
        x0, x1 = xs[i - 1], xs[i]
        y0, y1 = ys[i - 1], ys[i]
        t = (wavelength - x0) / (x1 - x0)
        return torch.where(inside, y0 + t * (y1 - y0), 0.0)


def make_array_spectrum(min_wl, max_wl, points) -> ArraySpectrum:
    return ArraySpectrum(float(min_wl), float(max_wl), np.asarray(points, np.float32))


def make_curve_spectrum(points) -> CurveSpectrum:
    pts = sorted((float(x), float(y)) for x, y in points)
    xs = np.array([p[0] for p in pts], np.float32)
    ys = np.array([p[1] for p in pts], np.float32)
    return CurveSpectrum(xs, ys)


# ---------------------------------------------------------------------------
# Baked colorimetric constants (the JAX package's data file, read by path).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def rgb_basis() -> ArraySpectrum:
    """Burns sRGB->spectral reflectance basis, [N, 3] over [360, 360+N]."""
    d = _data()
    span = d["rgb_basis_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["rgb_basis"])


@lru_cache(maxsize=1)
def xyz_response() -> ArraySpectrum:
    """CIE 1931 2-degree observer (x̄, ȳ, z̄) as one [N, 3] array spectrum."""
    d = _data()
    span = d["xyz_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["xyz_bar"])


@lru_cache(maxsize=1)
def d65() -> ArraySpectrum:
    d = _data()
    span = d["d65_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["d65"])


@lru_cache(maxsize=1)
def illuminant_a() -> ArraySpectrum:
    d = _data()
    span = d["illum_a_span"]
    return ArraySpectrum(float(span[0]), float(span[1]), d["illum_a"])


def builtin_spectrum(name: str):
    if name == "d65":
        return d65()
    if name == "a":
        return illuminant_a()
    raise ValueError(f"unknown builtin spectrum: {name}")


# ---------------------------------------------------------------------------
# Physics helpers.
# ---------------------------------------------------------------------------


def blackbody(wavelength_nm, temperature):
    """Planck's law (un-normalized, same constants as the reference)."""
    wl = wavelength_nm * 1.0e-9
    power_term = 3.74183e-16 * power(wl, -5.0)
    return power_term / (torch.exp(1.4388e-2 / (wl * temperature)) - 1.0)


def _pow5(x):
    """x^5 as x^2 * x^2 * x: the multiplication order of XLA's integer_pow,
    and of the CUDA kernels."""
    x2 = x * x
    return x2 * x2 * x


def schlick(ref_index1, ref_index2, normal, incident):
    """Schlick Fresnel approximation; ``normal``/``incident`` are [..., 3]."""
    cos_psi = -dot(normal, incident)
    r0 = (ref_index1 - ref_index2) / (ref_index1 + ref_index2)

    n = ref_index1 / ref_index2
    sin_t2 = n * n * (1.0 - cos_psi * cos_psi)
    tir = sin_t2 > 1.0
    cos_out = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    cos_psi = torch.where(ref_index1 > ref_index2, cos_out, cos_psi)

    inv_cos = 1.0 - cos_psi
    r = r0 * r0 + (1.0 - r0 * r0) * _pow5(inv_cos)
    return torch.where((ref_index1 > ref_index2) & tir, 1.0, r)


def fresnel(ior, env_ior, normal, incident):
    """Orientation-aware Fresnel (reference math.rs:167-175)."""
    entering = dot(incident, normal) < 0.0
    r_enter = schlick(env_ior, ior, normal, incident)
    r_exit = schlick(ior, env_ior, -normal, incident)
    return torch.where(entering, r_enter, r_exit)


# ---------------------------------------------------------------------------
# Spectrum development (binned film spectrum -> XYZ -> sRGB).
# ---------------------------------------------------------------------------


def sample_binned(bins, span, wavelength):
    """Sample a binned spectrum [..., B] the way the film does: nearest bin by
    floor, 0 outside [min, max]. ``wavelength`` is [T]. Returns [..., T]."""
    lo, hi = span
    nbins = bins.shape[-1]
    normalized = (wavelength - lo) / (hi - lo)
    idx = torch.clamp((normalized * nbins).long(), 0, nbins - 1)
    vals = bins[..., idx]
    inside = (wavelength >= lo) & (wavelength <= hi)
    return torch.where(inside, vals, 0.0)


def development_wavelengths(span, step_size):
    """The trapezoid sample points of the reference development loop:
    wl_0 = min, then += step while the left edge is < max (the last right edge
    may overshoot max; the binned spectrum reads 0 there)."""
    lo, hi = span
    steps = int(np.ceil((hi - lo) / step_size - 1e-6))
    return np.asarray(lo + step_size * np.arange(steps + 1), np.float32), steps


def spectrum_to_xyz(bins, span, step_size, sample_fn=None):
    """Integrate binned spectra [..., B] against the CIE observer.

    Returns XYZ [..., 3], scaled by 3.444 like the reference (main.rs:368).
    ``sample_fn(values, wavelengths)`` can post-process sampled intensities
    (the image ``filter``/``white`` pipeline)."""
    wl_np, steps = development_wavelengths(span, step_size)
    wl = torch.as_tensor(wl_np, device=bins.device)
    resp = xyz_response().sample(wl)  # [T, 3]
    s = sample_binned(bins, span, wl)  # [..., T]
    if sample_fn is not None:
        s = sample_fn(s, wl)
    trap = np.full(len(wl_np), 1.0, np.float32)
    trap[0] = 0.5
    trap[-1] = 0.5
    weights = torch.as_tensor(trap * step_size, device=bins.device)  # [T]
    sum_xyz = torch.matmul(s * weights, resp)
    total_weight = steps * step_size
    return sum_xyz * (3.444 / total_weight)


# sRGB (D65) matrix, as used by palette's Xyz->LinSrgb conversion.
XYZ_TO_LINEAR_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)


def xyz_to_linear_srgb(xyz):
    m = torch.as_tensor(XYZ_TO_LINEAR_SRGB, device=xyz.device)
    return torch.matmul(xyz, m.T)


def linear_to_srgb(linear):
    l = torch.clamp(linear, 0.0, 1.0)
    return torch.where(l <= 0.0031308, l * 12.92, 1.055 * l ** (1.0 / 2.4) - 0.055)


def develop_to_srgb(bins, span, step_size, sample_fn=None):
    """Full development: binned spectra [..., B] -> sRGB-encoded floats [..., 3]."""
    xyz = spectrum_to_xyz(bins, span, step_size, sample_fn)
    return linear_to_srgb(xyz_to_linear_srgb(xyz))
