"""Analysis start-time singleton: `Issue.discovery_time` is measured
against it (the port's copy of the JAX package's
support/start_time.py; reference: mythril/support/start_time.py)."""

from time import time

from mythril_tpu_torch.support.support_utils import Singleton


class StartTime(object, metaclass=Singleton):
    def __init__(self):
        self.global_start_time = time()
