"""The port's native C++ host libraries (copies of the reference's sources)
and their ctypes binds; ``build`` compiles them into
``nanomod_tpu_torch/_build/``."""

from nanomod_tpu_torch.native.build import load_native, require  # noqa: F401
