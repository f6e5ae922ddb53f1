from nns_tpu_torch.trees.beam import BeamIndex  # noqa: F401
from nns_tpu_torch.trees.kdtree import KDTree, nns_kdtree_host  # noqa: F401
from nns_tpu_torch.trees.kdtree_device import nns_kdtree_device  # noqa: F401
from nns_tpu_torch.trees.octree import Octree, nns_octree_host  # noqa: F401
from nns_tpu_torch.trees.octree_device import nns_octree_device  # noqa: F401
