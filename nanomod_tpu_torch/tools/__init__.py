"""The scale tools of the port: the reference's tools/scale_run.py,
scale_quality.py, scale_fullchain.py, scale_sharded.py and
bench_dp_buckets.py on the port's entry points, without jax, the JAX
package or h5py.  Run them as ``python -m nanomod_tpu_torch.tools.<name>``;
their data is drawn from the same seeds in the same order as the
reference's, so the genomes, planted sites and reads are the reference's.
"""
