"""Radial Fourier series analysis, id RADIAL_FOURIER (counterpart of
``libertem_tpu/analysis/radialfourier.py``).

Every (radial bin, order) pair is one complex mask,
``ring_b(r) * exp(i * order * phi)``, of one ApplyMasksUDF stack: the
per-frame Fourier coefficients of all bins and orders come out of one
complex product per block (the generic path: the fused kernel takes
real masks only).
"""
from __future__ import annotations

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..masks import polar_map, radial_bins
from ..udf.masks import ApplyMasksUDF
from ..viz.base import rgb_from_2dvector, visualize_simple
from .base import BaseAnalysis


def radial_fourier_masks(sig_shape, cx, cy, ri, ro, n_bins, max_order):
    """(n_bins * (max_order + 1), *sig) complex64 stack, unnormalised:
    antialiased ring b modulated by exp(i * order * phi)."""
    h, w = sig_shape
    bins = radial_bins(cx, cy, w, h, radius=ro, radius_inner=ri,
                       n_bins=n_bins)
    _, phi = polar_map(cx, cy, w, h)
    # the modulator in float64, cast once at the end: with a float32
    # phase, order * (phi - pi) drifts about 4e-7 rad from
    # order * phi - order * pi, mirrored pixels lose their exact
    # m(-p) = +-m(p) symmetry and symmetric frames stop cancelling.  In
    # float64 mirrored values agree within about 1e-15 relative, so the
    # final complex64 rounding lands them on the same float32.
    orders = np.arange(max_order + 1, dtype=np.float64)
    modulator = np.exp(1j * phi * orders[:, None, None])
    stack = bins[:, None, :, :].astype(np.float64) * modulator[None]
    return stack.reshape(-1, h, w).astype(np.complex64)


class RadialFourierAnalysis(BaseAnalysis, id_="RADIAL_FOURIER"):
    def get_parameters(self, parameters: dict) -> dict:
        h, w = tuple(self.dataset.shape.sig)
        # defaults: one bin, 24 orders (many bins would mean hundreds of
        # result channels)
        return {
            **parameters,
            "cx": parameters.get("cx", w / 2),
            "cy": parameters.get("cy", h / 2),
            "ri": parameters.get("ri") or 0,
            "ro": parameters.get("ro") or min(h, w) / 2,
            "n_bins": int(parameters.get("n_bins") or 1),
            "max_order": int(parameters.get("max_order") or 24),
        }

    def get_udf(self):
        p = self.parameters
        sig = tuple(self.dataset.shape.sig)

        def factory():
            return radial_fourier_masks(sig, p["cx"], p["cy"], p["ri"],
                                        p["ro"], p["n_bins"],
                                        p["max_order"])

        return ApplyMasksUDF(
            mask_factories=factory,
            mask_count=p["n_bins"] * (p["max_order"] + 1),
            mask_dtype=np.complex64,
        )

    def get_udf_results(self, udf_results, roi, damage):
        p = self.parameters
        n_bins, max_order = p["n_bins"], p["max_order"]
        dmg = self.nav_damage(damage)
        data = udf_results["intensity"].data
        nav_shape = data.shape[:-1]
        coeffs = data.reshape(nav_shape + (n_bins, max_order + 1))
        absolute = np.abs(coeffs)
        # the dominant order: positions where every higher order stays
        # below 20% of the bin's largest raw |c| get 0.  Under a roi the
        # positions outside hold nan: the threshold reduces with nanmax,
        # and those positions are marked nan explicitly
        invalid = np.isnan(absolute).any(axis=-1)  # (*nav, n_bins)
        threshold = np.nanmax(
            absolute[..., 1:].reshape(-1, n_bins, max_order),
            axis=(0, 2), initial=0.0,
        ) * 0.2
        below = np.all(absolute[..., 1:] < threshold[:, None], axis=-1)
        with np.errstate(invalid="ignore"):
            dominant = np.argmax(np.nan_to_num(absolute[..., 1:]),
                                 axis=-1) + 1.0
        dominant[below] = 0.0
        dominant[invalid] = np.nan
        results = []
        for b in range(n_bins):
            dom_b = dominant[..., b]
            results.append(AnalysisResult(
                raw_data=dom_b,
                visualized=lambda d=dom_b: visualize_simple(d, damage=dmg),
                key=f"dominant_{b}", title=f"dominant order [bin {b}]",
                desc="order with the largest relative Fourier "
                     "coefficient in this radial bin",
            ))
            for o in range(max_order + 1):
                arr = absolute[..., b, o]
                results.append(AnalysisResult(
                    raw_data=arr,
                    visualized=lambda a=arr: visualize_simple(a,
                                                              damage=dmg),
                    key=f"absolute_{b}_{o}", title=f"|c{o}| [bin {b}]",
                    desc=f"magnitude of Fourier order {o} in radial "
                         f"bin {b}",
                ))
                if o > 0:
                    ph = np.angle(coeffs[..., b, o])
                    results.append(AnalysisResult(
                        raw_data=ph,
                        visualized=lambda a=ph: visualize_simple(
                            a, damage=dmg),
                        key=f"phase_{b}_{o}", title=f"arg(c{o}) [bin {b}]",
                        desc=f"phase of Fourier order {o} in radial "
                             f"bin {b}",
                    ))
                carr = coeffs[..., b, o]
                results.append(AnalysisResult(
                    raw_data=carr,
                    visualized=lambda a=carr: rgb_from_2dvector(a.imag,
                                                                a.real),
                    key=f"complex_{b}_{o}", title=f"c{o} [bin {b}]",
                    desc=f"complex Fourier order {o} in radial bin {b}",
                ))
        return AnalysisResultSet(results, raw_results=udf_results)
