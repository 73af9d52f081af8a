"""Normalisation layer: softmax over the K neighbours."""

from stnls_tpu_torch.normz.softmax import SoftmaxNormalize
from stnls_tpu_torch.normz.api import init, extract_config, default_pairs

init_normz = init
