"""Host-side helpers of the learners (the port's copies of
``mrn_tpu/utils``): the loss ``Averager``, the experiment logs and the
``StepMeter``."""

from mrn_tpu_torch.utils.averager import Averager
from mrn_tpu_torch.utils.logging import ExperimentLog
from mrn_tpu_torch.utils.profiling import StepMeter

__all__ = ["Averager", "ExperimentLog", "StepMeter"]
