"""Usage scripts of the port (the JAX package's ``examples/``, each run with
``python -m xdeepfm_tpu_torch.examples.<name>``, on the GPU unless given
``--device cpu``): ``quickstart``, ``serving``, ``large_tables`` and
``sharded_training``.  Each has a ``main(...)`` whose keyword arguments
shrink it."""
