"""Cluster analysis, id CLUST: segment the scan by diffraction
similarity (counterpart of ``libertem_tpu/analysis/clust.py``).

Two passes run on the device: the standard deviation map (StdDevUDF),
then, at its strongest local maxima, a stack of small square templates
(ApplyMasksUDF; a sparse stack of ``n_peaks`` rows).  scikit-learn's
AgglomerativeClustering then labels the feature vectors on the host,
imported only there.  ``peak_local_max`` uses scipy.ndimage.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..common.analysis import AnalysisResult, AnalysisResultSet
from ..masks import ring, sparse_template_multi_stack
from ..udf.masks import ApplyMasksUDF
from ..udf.stddev import StdDevUDF
from ..viz.base import visualize_simple
from .base import BaseAnalysis


def peak_local_max(image: np.ndarray, min_distance: int = 1,
                   num_peaks: int = 100) -> np.ndarray:
    """(n, 2) coordinates of the local maxima above the mean, strongest
    first."""
    from scipy import ndimage
    image = np.asarray(image, dtype=np.float64)
    size = 2 * min_distance + 1
    maxed = ndimage.maximum_filter(image, size=size, mode="constant")
    coords = np.argwhere((image == maxed) & (image > image.mean()))
    if len(coords) == 0:
        return coords.reshape(0, 2)
    order = np.argsort(image[tuple(coords.T)])[::-1]
    return coords[order[:num_peaks]]


class ClusterAnalysis(BaseAnalysis, id_="CLUST"):
    def get_parameters(self, parameters: dict) -> dict:
        return {
            **parameters,
            "n_clust": parameters.get("n_clust") or 8,
            "n_peaks": parameters.get("n_peaks") or 42,
            "min_dist": parameters.get("min_dist") or 1,
            # the templates' half-width (0: single pixels)
            "rad": 2 if parameters.get("rad") is None else parameters["rad"],
            # an annulus restricting the peak search on the std map
            "cy": parameters.get("cy"),
            "cx": parameters.get("cx"),
            "ri": parameters.get("ri"),
            "ro": parameters.get("ro"),
        }

    def get_udf(self):
        return StdDevUDF()

    def feature_udf(self, std_map: np.ndarray) -> ApplyMasksUDF:
        """The feature pass: a (2 rad + 1)-square template at each of the
        std map's strongest local maxima (in the cy/cx/ri/ro annulus
        when all four are given)."""
        p = self.parameters
        search_map = std_map
        if all(p.get(k) is not None for k in ("cy", "cx", "ri", "ro")):
            sh, sw = std_map.shape
            search_map = std_map * np.asarray(
                ring(p["cx"], p["cy"], sw, sh, p["ro"], p["ri"]))
        peaks = peak_local_max(search_map, min_distance=p["min_dist"],
                               num_peaks=p["n_peaks"])
        if len(peaks) == 0:
            raise ValueError("no peaks found for clustering features")
        h, w = std_map.shape
        rad = int(p["rad"])
        template = np.ones((2 * rad + 1, 2 * rad + 1), np.float32)

        def factory():
            return sparse_template_multi_stack(
                mask_index=np.arange(len(peaks)),
                offsetY=peaks[:, 0] - rad, offsetX=peaks[:, 1] - rad,
                template=template, imageSizeY=h, imageSizeX=w,
            )

        return ApplyMasksUDF(mask_factories=factory, mask_count=len(peaks))

    def run_feature_passes(self, ctx, job_is_cancelled=None
                           ) -> Optional[tuple]:
        """The two device passes: (the std map, the features
        (*nav, n_peaks)); None when ``job_is_cancelled()`` turns true
        between them."""
        roi = self.get_roi()
        sd = ctx.run_udf(self.dataset, StdDevUDF(), roi=roi)
        if job_is_cancelled is not None and job_is_cancelled():
            return None
        std_map = np.asarray(sd["std"].data)
        feats = ctx.run_udf(self.dataset, self.feature_udf(std_map),
                            roi=roi)
        if job_is_cancelled is not None and job_is_cancelled():
            return None
        return std_map, np.asarray(feats["intensity"].data)

    def run_clustering(self, ctx, job_is_cancelled=None
                       ) -> AnalysisResultSet:
        """The whole pipeline: the two device passes, then
        AgglomerativeClustering of the features (with the scan grid's
        connectivity when every position is selected)."""
        passes = self.run_feature_passes(ctx, job_is_cancelled)
        if passes is None:
            return AnalysisResultSet([])
        features = passes[1]
        nav_shape = features.shape[:-1]
        flat = features.reshape(-1, features.shape[-1])
        # under a roi, only the selected positions: the nan fill must not
        # become a cluster of its own
        sel = np.isfinite(flat).all(axis=-1)
        from sklearn.cluster import AgglomerativeClustering
        from sklearn.feature_extraction.image import grid_to_graph
        conn = None
        if len(nav_shape) == 2 and sel.all():
            conn = grid_to_graph(*nav_shape)
        labels = AgglomerativeClustering(
            n_clusters=int(self.parameters["n_clust"]), connectivity=conn,
        ).fit_predict(flat[sel])
        label_map = np.full(flat.shape[0], np.nan, np.float32)
        label_map[sel] = labels
        label_map = label_map.reshape(nav_shape)
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=label_map,
                visualized=lambda: visualize_simple(label_map),
                key="intensity", title="cluster labels",
                desc="agglomerative clustering of diffraction features",
            ),
        ])

    def get_udf_results(self, udf_results, roi, damage):
        std = udf_results["std"].data
        return AnalysisResultSet([
            AnalysisResult(
                raw_data=std,
                visualized=lambda: visualize_simple(std),
                key="intensity", title="std",
                desc="standard deviation map (clustering runs via "
                     "run_clustering)",
            ),
        ], raw_results=udf_results)
