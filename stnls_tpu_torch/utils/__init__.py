from stnls_tpu_torch.utils.config import (
    extract_pairs, optional, optional_delete, ConfigDict,
)
from stnls_tpu_torch.utils import config
from stnls_tpu_torch.utils import misc
from stnls_tpu_torch.utils import timer
from stnls_tpu_torch.utils import mem
from stnls_tpu_torch.utils import mem as gpu_mem  # reference-name alias
from stnls_tpu_torch.utils import bench
from stnls_tpu_torch.utils import inds
from stnls_tpu_torch.utils import pads
from stnls_tpu_torch.utils import color
from stnls_tpu_torch.utils import vid_io
from stnls_tpu_torch.utils import mask
from stnls_tpu_torch.utils import debug
from stnls_tpu_torch.utils.inds import get_nums_hw, get_batching_info
from stnls_tpu_torch.utils.misc import flow2inds, inds2flow, set_seed
