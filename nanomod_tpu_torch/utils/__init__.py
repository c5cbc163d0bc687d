# Copied from nanomod_tpu/utils/__init__.py; differs in the imports and has
# no device_trace and no vlog.
from nanomod_tpu_torch.utils.observe import (
    Observer, observer, stage, report,
)

__all__ = ["Observer", "observer", "stage", "report"]
