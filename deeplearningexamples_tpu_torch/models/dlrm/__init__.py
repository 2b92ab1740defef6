from .model import Dlrm, DlrmConfig
from .task import DlrmTask, make_dlrm_optimizer
