from stnls_tpu_torch.utils.config import (
    extract_pairs, optional, optional_delete, ConfigDict,
)
from stnls_tpu_torch.utils import config
from stnls_tpu_torch.utils import color
