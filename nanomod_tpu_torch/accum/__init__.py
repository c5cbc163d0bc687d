# Copied from nanomod_tpu/accum/__init__.py; only the imports differ.
from nanomod_tpu_torch.accum.pools import PositionPools, PoolBuilder, join_pools  # noqa: F401
