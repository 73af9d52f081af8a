"""Testing utilities: naive ground truths, fixture data, gradient checks."""

from stnls_tpu_torch.testing import nls_gt
from stnls_tpu_torch.testing import agg_gt
from stnls_tpu_torch.testing import data
from stnls_tpu_torch.testing.checks import (
    find_duplicate_inds, check_shuffled_inds, gradcheck,
)
