"""Search layer: grid searches around flow-shifted centres."""

from stnls_tpu_torch.search import utils
from stnls_tpu_torch.search.non_local_search import (
    NonLocalSearch, _apply as nls, nls_pipeline,
)
from stnls_tpu_torch.search import non_local_search
from stnls_tpu_torch.search.api import init, extract_config, MENU
