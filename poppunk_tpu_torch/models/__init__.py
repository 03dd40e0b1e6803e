"""Model layer: the BGMM and refine / threshold fits and the artefact
loader (other model types raise until ported)."""

from .base import ClusterFit, load_cluster_fit  # noqa: F401
from .bgmm import BGMMFit, GaussianMixture  # noqa: F401
from .refine import RefineFit  # noqa: F401
