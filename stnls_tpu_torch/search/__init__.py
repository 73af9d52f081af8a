"""Search layer: grid searches around flow-shifted centres (PyTorch port
of stnls_tpu/search)."""

from stnls_tpu_torch.search import utils
from stnls_tpu_torch.search.non_local_search import (
    NonLocalSearch, _apply as nls, nls_pipeline,
)
from stnls_tpu_torch.search import non_local_search
from stnls_tpu_torch.search.refinement import RefineSearch, _apply as refine
from stnls_tpu_torch.search import refinement
from stnls_tpu_torch.search.paired_search import (
    PairedSearch, _apply as paired_search,
)
from stnls_tpu_torch.search import paired_search as paired_search_mod
from stnls_tpu_torch.search.paired_refine import (
    PairedRefine, _apply as paired_refine,
)
from stnls_tpu_torch.search.rand_inds import RandIndsSearch
from stnls_tpu_torch.search.n3mm_search import N3MatMultSearch
from stnls_tpu_torch.search.api import init, extract_config, MENU
from stnls_tpu_torch.search.utils import (
    empty_flow, search_wrap, get_time_window_inds,
)
