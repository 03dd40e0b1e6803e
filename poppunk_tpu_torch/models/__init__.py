"""Model layer: the BGMM fit and the artefact loader (other model types
raise until ported)."""

from .base import ClusterFit, load_cluster_fit  # noqa: F401
from .bgmm import BGMMFit, GaussianMixture  # noqa: F401
