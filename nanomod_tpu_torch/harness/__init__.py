"""The simulate / simulat2 / DownSampling evaluation harness on the port's
detect (nanomod_tpu_torch.detect)."""

from nanomod_tpu_torch.harness.simulate import (  # noqa: F401
    load_group_reads,
    mix_and_rank,
    run_downsampling,
    run_simulat2,
    run_simulate,
)
