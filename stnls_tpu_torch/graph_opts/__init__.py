"""Graph-ops layer (PyTorch port of stnls_tpu/graph_opts): the support of
NonLocalScatter, slot labels and slot-indexed scatter/gather of per-edge
tensors."""

from stnls_tpu_torch.graph_opts import scatter_labels
from stnls_tpu_torch.graph_opts import scatter_tensor
from stnls_tpu_torch.graph_opts import gather_tensor
