from controlvar_tpu_torch.utils.misc import seed_everything, SmoothedValue, MetricLogger  # noqa: F401
from controlvar_tpu_torch.utils.tracker import Tracker  # noqa: F401
