"""Subpackage of nanomod_tpu_torch; import its modules directly."""
