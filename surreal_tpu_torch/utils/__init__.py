from surreal_tpu_torch.utils import guards
from surreal_tpu_torch.utils.logger import get_logger
from surreal_tpu_torch.utils.trackers import PeriodicTracker, ThroughputTracker
