"""Model layer: the BGMM, DBSCAN, refine / threshold and lineage fits and
the artefact loader."""

from .base import ClusterFit, load_cluster_fit  # noqa: F401
from .bgmm import BGMMFit, GaussianMixture  # noqa: F401
from .dbscan import DBSCANFit  # noqa: F401
from .lineage import LineageFit  # noqa: F401
from .refine import RefineFit  # noqa: F401
